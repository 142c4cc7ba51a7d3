"""Fault-tolerant checkpointing of train states (nested dicts of tensors).

Counterpart of ``repro/ckpt/checkpoint.py``, in the same on-disk format, so
each side reads the other's files:

* **atomic**: writes go to ``step_N.tmp/``, then one ``os.rename``
  publishes ``step_N/``; a crashed writer never corrupts the latest
  checkpoint, and unpublished ``.tmp`` directories are ignored;
* **self-describing**: a msgpack manifest (``step``, ``skeleton``,
  ``entries`` with each blob's ``file``, ``dtype``, ``shape``, ``crc32`` and
  ``compressed``, ``format`` 1) beside one ``arr_%06d.bin`` blob per leaf,
  leaves in sorted-key order as JAX flattens dicts;
* **integrity**: each blob's crc32 is checked on restore;
* **async**: ``save(..., blocking=False)`` copies every tensor to host
  memory before it returns, then writes on a daemon thread, so the loop
  may step on; one save is in flight at a time;
* **keep-k**: old steps are removed after a successful publish;
* **across ranks**: a state holding DTensors is saved by every rank of
  the default process group: each DTensor leaf is gathered on every rank
  (``full_tensor()``), rank 0 alone writes and publishes, and every rank
  waits on a barrier after a blocking save and after ``wait()`` for an
  async one, so no rank reads ``latest_step()`` before the publish.  The
  files are those of a save on one device.  A plain state is written by
  whoever saves it, as on one device;
* **elastic restore**: ``restore(shardings=...)`` keeps each rank's block
  of every leaf on the restoring mesh (``sharding.device_put``), which
  may differ from the saving one: a checkpoint saved on four ranks
  restores on one, and one saved on one restores on four.

bf16 leaves are written as their raw bytes with the dtype string ``'<V2'``,
which is what the reference writes for a bfloat16 array, and read back as
``torch.bfloat16``.  Blobs are written uncompressed (``compressed`` False),
as the reference does without ``zstandard``; a compressed blob raises
``ImportError`` on restore.  ``restore(device=...)`` reads the state onto
the named device, and with ``shardings`` (a ``sharding.to_named`` tree)
places it on their mesh, as the reference's ``restore(step, shardings)``.
The manifest is encoded by ``msgpack_lite``: this module imports neither
``msgpack`` nor JAX.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import msgpack_lite
from repro_torch.distributed import ctx
from repro_torch.utils import tree_flatten, tree_map, whole

_MANIFEST = "manifest.msgpack"
_BF16 = "<V2"      # numpy's dtype string for a bfloat16 array


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3                # no compress_level: blobs are written raw


def _skeleton(tree: Any):
    """The nested-dict structure with None leaves, keys sorted."""
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    return None


def _rebuild(skel, values: dict, prefix=""):
    if isinstance(skel, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in skel.items()}
    if isinstance(skel, list):
        return [_rebuild(v, values, f"{prefix}{i}/")
                for i, v in enumerate(skel)]
    return values[prefix[:-1]]


def _blob(t: torch.Tensor) -> tuple[bytes, str]:
    """A host tensor's raw bytes and its manifest dtype string."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes(), _BF16
    arr = t.numpy()
    return arr.tobytes(), arr.dtype.str


def _to_tensor(raw: bytes, dtype: str, shape: list, device) -> torch.Tensor:
    if dtype == _BF16:
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        t = torch.from_numpy(arr.copy())
    return t.to(device)


class Checkpointer:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.dir = Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # an async save of DTensors not yet waited for on every rank
        self._collective = False

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        """Snapshot ``state`` (device → host) and persist it.  A state
        holding DTensors is saved by every rank of the default group: each
        DTensor leaf is gathered, rank 0 writes, and a blocking save
        returns on every rank after the publish."""
        self.wait()                      # one in-flight save at a time
        collective = ctx.placed(state)
        writer = not collective or dist.get_rank() == 0

        def snapshot(t):
            # a copy even of a CPU tensor, so that no later in-place update
            # of the live state reaches the snapshot; leaf by leaf, so the
            # device holds one gathered leaf at a time
            value = whole(t.detach())
            return value.to("cpu", copy=True) if writer else None
        host = tree_map(snapshot, state)
        if blocking:
            if writer:
                self._write(step, host)
            if collective:
                dist.barrier()
        else:
            self._collective = collective
            if writer:
                self._thread = threading.Thread(
                    target=self._write_async, args=(step, host),
                    daemon=True)
                self._thread.start()

    def wait(self) -> None:
        """Join the save in flight, and after a save of DTensors wait for
        every rank; re-raise what the save raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective:
            self._collective = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step: int, host_state: Any) -> None:
        try:
            self._write(step, host_state)
        except BaseException as e:       # handed to the caller by wait()
            self._error = e

    def _write(self, step: int, host_state: Any) -> None:
        final = self.dir / f"step_{step:012d}"
        tmp = self.dir / f"step_{step:012d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        entries = {}
        for i, (path, leaf) in enumerate(tree_flatten(host_state)):
            blob, dtype = _blob(leaf)
            fname = f"arr_{i:06d}.bin"
            (tmp / fname).write_bytes(blob)
            entries[path] = {
                "file": fname,
                "dtype": dtype,
                "shape": list(leaf.shape),
                "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
                "compressed": False,
            }
        manifest = {
            "step": step,
            "skeleton": _skeleton(host_state),
            "entries": entries,
            "format": 1,
        }
        (tmp / _MANIFEST).write_bytes(msgpack_lite.packb(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.cfg.keep]:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / _MANIFEST).exists():
                continue                 # unpublished/corrupt: ignored
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, device,
                shardings: Any = None) -> Any:
        """Load a checkpoint (the latest by default) as tensors on
        ``device``; there is no default device.  With ``shardings`` (a
        ``sharding.to_named`` tree of the state's structure) every rank
        reads the files and keeps its own block of each leaf on their mesh
        (``sharding.device_put``), whatever mesh saved them."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:012d}"
        manifest = msgpack_lite.unpackb((d / _MANIFEST).read_bytes())

        values = {}
        for path, e in manifest["entries"].items():
            blob = (d / e["file"]).read_bytes()
            if (zlib.crc32(blob) & 0xFFFFFFFF) != e["crc32"]:
                raise IOError(f"checksum mismatch for {path} at step {step}")
            if e["compressed"]:
                raise ImportError(
                    f"checkpoint step {step} is zstd-compressed but "
                    "the 'zstandard' package is not installed")
            values[path] = _to_tensor(blob, e["dtype"], e["shape"], device)
        state = _rebuild(manifest["skeleton"], values)
        if shardings is None:
            return state
        from repro_torch.distributed import sharding
        return sharding.device_put(state, shardings)
