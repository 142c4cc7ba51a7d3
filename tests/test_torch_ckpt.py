"""The port's checkpointer against repro.ckpt: the reference's own cases
(round trip, keep-k, async, corrupt blob, unpublished .tmp, restore onto a
named device), bf16, async saves that race the next step, files crossing
over both ways, the manifest's msgpack bytes, loop resume, and saves of
DTensor states across two gloo ranks (the barrier, the gathered blobs)."""
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import (CheckpointConfig as JCheckpointConfig,
                                   Checkpointer as JCheckpointer)
from repro.models import layers as JL, registry as jreg
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.ckpt import msgpack_lite
from repro_torch.ckpt.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train
from repro_torch.models import layers as TL, registry as treg
from repro_torch.train import loop, train_step as tts
from repro_torch.utils import tree_flatten


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "step": torch.tensor(7, dtype=torch.int32),
        "branch": {"w": torch.randn((16, 32), generator=gen),
                   "b": torch.zeros((32,))},
        "opt": {"mu": {"w": torch.ones((16, 32)) * 0.5,
                       "b": torch.zeros((32,))},
                "step": torch.tensor(3, dtype=torch.int32)},
    }


def _assert_equal_trees(got, want):
    gf, wf = tree_flatten(got), tree_flatten(want)
    assert [p for p, _ in gf] == [p for p, _ in wf]
    for (p, g), (_, w) in zip(gf, wf):
        assert g.dtype == w.dtype and g.shape == w.shape, p
        assert torch.equal(g.cpu(), w.cpu()), p


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    state = _state()
    ck.save(7, state)
    out = ck.restore(device="cpu")
    _assert_equal_trees(out, state)
    assert out["step"].dtype == torch.int32 and out["step"].shape == ()
    assert out["opt"]["step"].dtype == torch.int32


def test_keep_k_gc(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), keep=2))
    for s in (1, 2, 3, 4):
        ck.save(s, _state())
    assert ck.all_steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    ck.save(5, _state(), blocking=False)
    ck.wait()
    assert ck.latest_step() == 5


def test_corrupt_blob_detected(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    ck.save(1, _state())
    d = next(Path(tmp_path).glob("step_*"))
    victim = next(d.glob("arr_*.bin"))
    victim.write_bytes(b"corrupted!")
    with pytest.raises(IOError, match="checksum"):
        ck.restore(device="cpu")


def test_unpublished_tmp_ignored(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    ck.save(1, _state())
    (Path(tmp_path) / "step_000000000009.tmp").mkdir()
    assert ck.latest_step() == 1


def test_restore_onto_a_named_device(tmp_path):
    """The counterpart of the reference's elastic restore: the state comes
    back on the device the caller names, and there is no default."""
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    state = _state()
    ck.save(3, state)
    out = ck.restore(device=torch.device("cpu"))
    assert all(t.device.type == "cpu" for _, t in tree_flatten(out))
    _assert_equal_trees(out, state)
    meta = ck.restore(device="meta")
    assert all(t.device.type == "meta" for _, t in tree_flatten(meta))
    with pytest.raises(TypeError):
        ck.restore()


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(CheckpointConfig(str(tmp_path))).restore(device="cpu")


def test_bf16_roundtrip_is_bit_exact(tmp_path):
    gen = torch.Generator().manual_seed(1)
    state = {"step": torch.tensor(2, dtype=torch.int32),
             "backbone": {"w": torch.randn((33, 17), generator=gen)
                          .bfloat16(),
                          "s": torch.tensor([-0.0, float("inf"), 1e-40,
                                             float("nan")]).bfloat16()}}
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    ck.save(2, state)
    manifest = msgpack.unpackb(
        (tmp_path / "step_000000000002" / "manifest.msgpack").read_bytes())
    assert manifest["entries"]["backbone/w"]["dtype"] == "<V2"
    out = ck.restore(device="cpu")
    for p, t in tree_flatten(state["backbone"]):
        got = out["backbone"][p]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), t.view(torch.int16)), p


def test_async_save_keeps_the_values_it_was_given(tmp_path):
    """The host copy is taken before save returns: the next step may
    overwrite the live state, in place or by rebinding, at once."""
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    state = _state()
    want = {k: v.clone() for k, v in tree_flatten(state)}
    ck.save(7, state, blocking=False)
    state["branch"]["w"].add_(1.0)
    state["opt"]["mu"]["w"].zero_()
    state["step"] += 1
    state["branch"]["b"] = torch.full((32,), 9.0)
    ck.wait()
    out = dict(tree_flatten(ck.restore(device="cpu")))
    for k, v in want.items():
        assert torch.equal(out[k], v), k


def test_async_write_error_raises_at_wait(tmp_path, monkeypatch):
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))

    def fail(step, host):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write", fail)
    ck.save(1, _state(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                            # the error is handed over once


def test_compressed_entry_raises_import_error(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    ck.save(1, _state())
    path = tmp_path / "step_000000000001" / "manifest.msgpack"
    manifest = msgpack_lite.unpackb(path.read_bytes())
    for e in manifest["entries"].values():
        e["compressed"] = True
    path.write_bytes(msgpack_lite.packb(manifest))
    with pytest.raises(ImportError, match="zstandard"):
        ck.restore(device="cpu")


# ------------------------------------------------------------ interop

def _jax_duplex_state(backbone_dtype=jnp.bfloat16):
    from repro.core import duplex as jdx
    entry = jreg.get("granite-3-8b")
    tcfg = jts.TrainConfig(
        mode="duplex", backbone_dtype=backbone_dtype,
        duplex=jdx.DuplexConfig(n_blocks=2, d_branch=16, pool_factor=4,
                                branch_heads=2))
    st = jts.init_state(jax.random.PRNGKey(0), entry, entry.smoke, tcfg,
                        JL.Policy(compute_dtype=jnp.float32))
    return jax.tree_util.tree_map(np.asarray, st)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A JAX duplex state (bf16 backbone) written uncompressed by repro.ckpt
    (``compress_level=0``, or any level without ``zstandard``) restores
    equal to bridge.state_from_jax of that state, leaf for leaf."""
    st = _jax_duplex_state()
    assert str(st["backbone"]["embed"]["table"].dtype) == "bfloat16"
    JCheckpointer(JCheckpointConfig(str(tmp_path), compress_level=0)).save(
        0, st)
    out = Checkpointer(CheckpointConfig(str(tmp_path))).restore(device="cpu")
    _assert_equal_trees(out, bridge.state_from_jax(st, "cpu"))


def test_reference_checkpoint_at_its_default_level(tmp_path):
    """At its default level the reference compresses with zstd when
    ``zstandard`` is installed; the port, which has no zstd, then raises the
    reference's ImportError, and otherwise restores the file."""
    st = _jax_duplex_state()
    JCheckpointer(JCheckpointConfig(str(tmp_path))).save(0, st)
    manifest = msgpack.unpackb(
        (tmp_path / "step_000000000000" / "manifest.msgpack").read_bytes())
    ck = Checkpointer(CheckpointConfig(str(tmp_path)))
    if any(e["compressed"] for e in manifest["entries"].values()):
        with pytest.raises(ImportError, match="zstandard"):
            ck.restore(device="cpu")
    else:
        _assert_equal_trees(ck.restore(device="cpu"),
                            bridge.state_from_jax(st, "cpu"))


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    """A port state written by the port restores through repro.ckpt: f32
    and int leaves equal, bf16 leaves equal as bytes (they come back as
    numpy 'V2')."""
    entry = treg.get("granite-3-8b")
    from repro_torch.core import duplex as tdx
    tcfg = tts.TrainConfig(mode="duplex", duplex=tdx.DuplexConfig(
        n_blocks=2, d_branch=16, pool_factor=4, branch_heads=2))
    state = tts.init_state(torch.Generator().manual_seed(0), entry,
                           entry.smoke, tcfg, TL.Policy())
    Checkpointer(CheckpointConfig(str(tmp_path))).save(4, state)
    out = JCheckpointer(JCheckpointConfig(str(tmp_path))).restore()
    flat = dict(tree_flatten(out))
    assert sorted(flat) == [p for p, _ in tree_flatten(state)]
    for p, t in tree_flatten(state):
        got = flat[p]
        assert list(got.shape) == list(t.shape), p
        if t.dtype == torch.bfloat16:
            assert got.dtype.str == "|V2"
            assert got.tobytes() == t.view(torch.int16).numpy().tobytes(), p
        else:
            np.testing.assert_array_equal(got, t.numpy(), err_msg=p)


@pytest.mark.parametrize("bb_dtype", ["bfloat16", "float32"])
def test_manifest_bytes_match_the_reference(tmp_path, bb_dtype):
    """For one state, both sides write the same manifest and blobs (the
    reference uncompressed, as the port writes)."""
    st = _jax_duplex_state(getattr(jnp, bb_dtype))
    JCheckpointer(JCheckpointConfig(str(tmp_path / "jax"),
                                    compress_level=0)).save(3, st)
    Checkpointer(CheckpointConfig(str(tmp_path / "torch"))).save(
        3, bridge.state_from_jax(st, "cpu"))
    dj, dt = (tmp_path / side / "step_000000000003" for side in
              ("jax", "torch"))
    assert sorted(p.name for p in dj.iterdir()) == \
        sorted(p.name for p in dt.iterdir())
    for p in dj.iterdir():
        assert p.read_bytes() == (dt / p.name).read_bytes(), p.name


# ------------------------------------------------------------ msgpack

EDGE_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
             -2**31 - 1, -2**63]
EDGE_VALUES = [None, True, False, "", "a" * 31, "b" * 32, "c" * 255,
               "d" * 256, "e" * 65535, "f" * 65536, "ünïcödé €",
               list(range(15)), list(range(16)), list(range(70000)), [],
               {}, {f"k{i}": i for i in range(15)},
               {f"k{i}": i for i in range(16)},
               {f"k{i}": None for i in range(70000)},
               {"nested": {"a": [1, [2, [3, {"b": None}]]], "c": True}}]


@pytest.mark.parametrize("value", EDGE_INTS + EDGE_VALUES,
                         ids=lambda v: repr(v)[:24])
def test_msgpack_lite_bytes_equal_packb(value):
    want = msgpack.packb(value)
    assert msgpack_lite.packb(value) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want)


def _random_manifest(rng: random.Random, depth=0):
    kind = rng.choice(["int", "str", "bool", "none", "list", "dict"]
                      if depth < 4 else ["int", "str", "bool", "none"])
    if kind == "int":
        return rng.choice([rng.randrange(-2**63, 2**64),
                           rng.randrange(-300, 70000)])
    if kind == "str":
        return "".join(rng.choice("ab_/0ü") for _ in
                       range(rng.choice([0, 5, 31, 32, 300])))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "none":
        return None
    n = rng.choice([0, 3, 15, 16, 17])
    if kind == "list":
        return [_random_manifest(rng, depth + 1) for _ in range(n)]
    return {f"key{i}_{rng.randrange(99)}": _random_manifest(rng, depth + 1)
            for i in range(n)}


@pytest.mark.parametrize("seed", range(8))
def test_msgpack_lite_random_trees_match_packb(seed):
    value = _random_manifest(random.Random(seed))
    want = msgpack.packb(value)
    assert msgpack_lite.packb(value) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want)


@pytest.mark.parametrize("value", [1.5, b"bytes", 2**64, -2**63 - 1,
                                   object()],
                         ids=["float", "bytes", "2**64", "-2**63-1",
                              "object"])
def test_msgpack_lite_refuses_what_a_manifest_never_holds(value):
    with pytest.raises((TypeError, ValueError)):
        msgpack_lite.packb(value)


def test_msgpack_lite_refuses_trailing_bytes():
    with pytest.raises(ValueError, match="extra"):
        msgpack_lite.unpackb(msgpack.packb(1) + b"\x00")


# ------------------------------------------------------------ loop resume

def _smoke_loop(tmp, total, ckpt_every=2):
    entry, cfg, tcfg, policy = train.build("granite-3-8b", "smoke")
    step = tts.make_train_step(entry, cfg, tcfg, policy)

    def init_fn():
        return tts.init_state(torch.Generator().manual_seed(0), entry, cfg,
                              tcfg, policy)

    def step_fn(state, batch):
        return step(state, {k: torch.from_numpy(v).long()
                            for k, v in batch.items()})

    return loop.run(
        loop.LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                        ckpt=CheckpointConfig(str(tmp)) if tmp else None,
                        log_every=1),
        DataConfig(vocab=cfg.vocab, seq_len=32, batch_per_host=4, seed=0),
        step_fn, init_fn, log_fn=lambda s: None, device="cpu")


def test_loop_resume_is_bit_exact(tmp_path):
    straight = _smoke_loop(None, 4)
    first = _smoke_loop(tmp_path, 2)
    assert first.resumed_from is None
    assert Checkpointer(CheckpointConfig(str(tmp_path))).all_steps() == [2]
    saved = Checkpointer(CheckpointConfig(str(tmp_path))).restore(
        device="cpu")
    _assert_equal_trees(saved, first.state)
    resumed = _smoke_loop(tmp_path, 4)
    assert resumed.resumed_from == 2 and resumed.steps_run == 2
    assert [m["step"] for m in resumed.metrics_history] == [2, 3]
    want = {m["step"]: m["loss"] for m in straight.metrics_history}
    for m in resumed.metrics_history:
        assert m["loss"] == want[m["step"]]
    _assert_equal_trees(resumed.state, straight.state)
    assert int(resumed.state["step"]) == 4


def test_loop_with_checkpoints_needs_a_device(tmp_path):
    with pytest.raises(ValueError, match="device"):
        loop.run(loop.LoopConfig(total_steps=1,
                                 ckpt=CheckpointConfig(str(tmp_path))),
                 None, None, None)


def test_launcher_resumes_from_ckpt_dir(tmp_path, capsys):
    base = ["--arch", "granite-3-8b", "--preset", "smoke", "--seq", "32",
            "--batch", "4", "--device", "cpu", "--log-every", "1"]
    straight = train.main(base + ["--steps", "4"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train.main(base + ["--steps", "2"] + ck)
    assert first["report"].resumed_from is None
    resumed = train.main(base + ["--steps", "4"] + ck)
    report = resumed["report"]
    assert report.resumed_from == 2 and report.steps_run == 2
    assert "resumed from step 2" in capsys.readouterr().out
    want = {m["step"]: m["loss"] for m in straight["report"].metrics_history}
    for m in report.metrics_history:
        assert m["loss"] == want[m["step"]]
    _assert_equal_trees(report.state, straight["report"].state)
    assert resumed["backbone_checksum"][0] is None
    assert resumed["backbone_checksum"][1] == \
        straight["backbone_checksum"][1]
    assert all(math.isfinite(m["loss"]) for m in report.metrics_history)
    assert Checkpointer(CheckpointConfig(str(tmp_path))).latest_step() == 4


def test_example_trains_and_resumes(tmp_path, capsys):
    from repro_torch.examples import train_duplex_lm
    base = ["--d-model", "32", "--layers", "2", "--seq", "32", "--batch",
            "2", "--vocab", "64", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--device", "cpu"]
    first = train_duplex_lm.main(base + ["--steps", "4"])
    assert first.resumed_from is None and first.steps_run == 4
    again = train_duplex_lm.main(base + ["--steps", "6"])
    assert again.resumed_from == 4 and again.steps_run == 2
    assert int(again.state["step"]) == 6
    assert "step" in again.state["opt"]          # AdamW's step survived
    assert again.state["opt"]["step"].dtype == torch.int32
    assert int(again.state["opt"]["step"]) == 6
    assert "resumed from step 4" in capsys.readouterr().out


# ------------------------------------------------------------ across ranks

TWO_RANKS = r"""
import sys, time
from datetime import timedelta
from pathlib import Path
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from repro_torch.ckpt.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.distributed import sharding as sh
d, rank = Path(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=2, timeout=timedelta(seconds=60))
try:
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    gen = torch.Generator().manual_seed(0)
    state = {"step": torch.tensor(5, dtype=torch.int32),
             "w": torch.randn((6, 4), generator=gen),
             "h": torch.randn((4, 6), generator=gen).to(torch.bfloat16)}
    named = {"step": sh.NamedSharding(mesh, (Replicate(),)),
             "w": sh.NamedSharding(mesh, (Shard(0),)),
             "h": sh.NamedSharding(mesh, (Shard(1),))}
    placed = sh.device_put(state, named)
    # rank 0's writes are slowed, so that a rank that did not wait for the
    # publish would find nothing
    write = Checkpointer._write
    def slow_write(self, step, host):
        time.sleep(1.0)
        write(self, step, host)
    Checkpointer._write = slow_write
    seen = []
    ck = Checkpointer(CheckpointConfig(str(d / "mesh")))
    ck.save(1, placed, blocking=True)
    seen.append(ck.latest_step())
    ck.save(2, placed, blocking=False)
    ck.wait()
    seen.append(ck.latest_step())
    Checkpointer._write = write
    if rank == 0:
        Checkpointer(CheckpointConfig(str(d / "plain"))).save(2, state)
    dist.barrier()
    back = Checkpointer(CheckpointConfig(str(d / "mesh"))).restore(
        device="cpu", shardings=named)
    same = all(torch.equal(back[k].to_local(), placed[k].to_local()) and
               tuple(back[k].placements) == tuple(placed[k].placements)
               for k in state)
    print("SEEN", seen, "RESTORED", same)
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """A state of one replicated and two split leaves (f32, bf16) saved as
    DTensors by two gloo ranks, each a process, blocking at step 1 and
    async at step 2, with rank 0's writes slowed by a second; the same
    state saved plain at step 2.  Returns each rank's output and the
    directory."""
    d = tmp_path_factory.mktemp("two")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).parents[1] / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", TWO_RANKS, str(d),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return outs, d


@pytest.mark.parametrize("rank", [0, 1])
def test_no_rank_sees_an_unpublished_step(rank, two_ranks):
    """After a blocking save, and after ``wait()`` for an async one, every
    rank finds the step published, though only rank 0 writes it, slowly;
    each rank restores its own block, placed as saved."""
    outs, _ = two_ranks
    assert "SEEN [1, 2] RESTORED True" in outs[rank]


def test_blobs_of_a_gathered_dtensor_are_the_plain_saves(two_ranks):
    _, d = two_ranks
    mesh, plain = d / "mesh" / f"step_{2:012d}", d / "plain" / f"step_{2:012d}"
    names = sorted(f.name for f in plain.iterdir())
    assert names == sorted(f.name for f in mesh.iterdir())
    assert len(names) == 4                    # three blobs and the manifest
    for name in names:
        assert (mesh / name).read_bytes() == (plain / name).read_bytes(), \
            name
