"""The launchers across ranks: ``--mesh`` and ``--distributed`` of
``launch/{train,serve}.py``, the flash kernel's route on DTensors, the kernel
wrappers' refusal of a DTensor, and checkpoints across meshes.

* Errors: ``--mesh pod`` / ``multipod`` without ``--distributed`` raise,
  naming the 256 / 512 ranks they need; ``--distributed`` without
  torchrun's environment raises, naming the missing variable; every kernel
  wrapper raises ``TypeError`` on a DTensor operand.
* One gloo rank in this process: for each of the ten archs at SMOKE
  (the launcher's ``build``: f32, BFP (3, 3) on a 32-wide branch), 3 steps
  of ``train`` on a one-rank host mesh give the plain launcher's final
  branch, momentum, step and loss history bit for bit, each leaf of the
  final state a DTensor with its placements.
* Four gloo ranks, each a process, all cases in one launch (2 train
  steps a run): the CLI with
  ``--distributed --mesh host`` (a (4, 1) host mesh) for granite-3-8b and
  mamba2-780m; ``train`` on a (2, 2) mesh for granite-3-8b with
  ``use_flash`` (the flash route on each rank's block: heads split, the
  kernel's plain version on the CPU), granite-moe-1b-a400m, and
  llama4-maverick-400b-a17b with ``use_flash`` (5 heads: the rules split
  the sequence, which the flash route gathers first); ``serve``
  on (2, 2) for granite-3-8b, gemma2-9b (a 12-token prompt wraps its ring
  of 8), mamba2-780m (``ssd`` states) and whisper-base (the cross cache):
  the tokens equal the plain serve's; a checkpoint saved at step 2 by the
  four ranks and resumed by a plain run to step 4, and a plain checkpoint
  resumed on the four ranks, each equal to the straight plain 4-step run.
  The gathered states and losses are held to the plain runs within
  ``torch.testing.assert_close``'s defaults for their dtype, as
  ``tests/test_torch_train_cells.py`` holds its four-rank steps (the shards
  sum in another order).
* Against JAX: one subprocess with four CPU devices runs the reference's
  launcher path on its own functions (``state_pspecs``, ``to_named``,
  ``device_put``, ``activation_sharding``, ``make_train_step``, as
  ``repro/launch/train.py:64-80``, on ``make_host_mesh``'s (4, 1) mesh
  built as ``jax.sharding.Mesh``: ``make_host_mesh`` calls
  ``jax.make_mesh``, whose axes are Explicit under jax 0.9, and the
  embedding's gather under ``with mesh`` then raises) for
  granite-3-8b SMOKE duplex, 2 steps on fixed numpy batches; the four
  ranks take the same initial state through ``bridge.state_from_jax``,
  place it and the batches as the launcher does on a (4, 1) host mesh, and
  step under the activation rules.  The gathered state and metrics agree
  within ``tests/test_torch_train_step.py``'s tolerances (rtol 1e-5, atol
  1e-6).  Flash is off: JAX's flash has no CPU path (``attn_cfg_for``
  passes no ``flash_interpret``).
JAX runs only in that subprocess; this module imports none of it.
"""
import dataclasses as dc
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import bfp_common as bc, bfp_matmul as bm, \
    bfp_quant as bq, flash_attention as fa, ops
from repro_torch.launch import mesh as lmesh, serve, train
from repro_torch.models import registry
from repro_torch.utils import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(registry.ARCHS)
SEQ, BATCH, STEPS = 32, 4, 3
FOUR_STEPS = 2          # the four-rank train runs: each rank is CPU-bound
# (arch, use_flash) of the (2, 2) train runs: granite splits its 4 heads
# over `model`, llama4 its sequence (5 heads), which the flash route gathers
TRAIN_22 = [("granite-3-8b", True), ("granite-moe-1b-a400m", False),
            ("llama4-maverick-400b-a17b", True)]
CLI_HOST = ["granite-3-8b", "mamba2-780m"]
# (arch, prompt length) of the (2, 2) serve runs
SERVE_22 = [("granite-3-8b", 8), ("gemma2-9b", 12), ("mamba2-780m", 8),
            ("whisper-base", 8)]
GEN = 4
TRAINED = ("branch", "opt", "step")


def build(arch: str, use_flash: bool = False):
    entry, cfg, tcfg, policy = train.build(arch, "smoke")
    return entry, dc.replace(cfg, use_flash=use_flash), tcfg, policy


def run_train(arch: str, *, use_flash: bool = False, steps: int = STEPS,
              mesh=None, ckpt_dir=None):
    entry, cfg, tcfg, policy = build(arch, use_flash)
    return train.train(entry, cfg, tcfg, policy, steps=steps, seq=SEQ,
                       batch=BATCH, device="cpu", mesh=mesh,
                       ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                       ckpt_every=2, log_every=1)


def run_serve(arch: str, prompt: int, mesh=None):
    entry = registry.get(arch)
    return serve.serve(entry, entry.smoke, batch=BATCH, prompt_len=prompt,
                       gen=GEN, dtype=torch.float32, device="cpu",
                       mesh=mesh)


def cli(arch: str, steps: int = STEPS) -> list:
    return ["--arch", arch, "--preset", "smoke", "--steps", str(steps),
            "--seq", str(SEQ), "--batch", str(BATCH), "--device", "cpu",
            "--log-every", "1"]


def moved_placements(state, mesh) -> list:
    """The paths whose leaf is not a DTensor laid out by the launcher's
    ``state_pspecs`` on ``mesh``."""
    from torch.distributed.tensor import DTensor
    named = dict(tree_flatten(sh.to_named(sh.state_pspecs(state, mesh),
                                          mesh)))
    return [p for p, t in tree_flatten(state)
            if not isinstance(t, DTensor) or
            tuple(t.placements) != tuple(named[p].placements)]


def summary(out: dict, mesh=None) -> dict:
    """What a train run is compared by: the trained leaves' whole values,
    the loss history, where the run resumed, and on a ``mesh`` the leaves
    that left their placements."""
    return {"state": dict(tree_flatten({k: out["state"][k]
                                        for k in TRAINED})),
            "losses": [m["loss"] for m in out["history"]],
            "resumed_from": out["report"].resumed_from,
            "moved": [] if mesh is None else
            moved_placements(out["report"].state, mesh)}


def summary_cli(out: dict) -> dict:
    """``summary`` of a CLI run on a mesh, read from its state's own mesh
    (the launcher has destroyed the group by then), and the mesh's
    shape."""
    from torch.distributed.tensor import DTensor
    mesh = next(t for _, t in tree_flatten(out["report"].state)
                if isinstance(t, DTensor)).device_mesh
    return {**summary(out, mesh), "mesh": tuple(mesh.shape)}


def assert_same_run(got: dict, want: dict, exact: bool = False) -> None:
    assert got["state"].keys() == want["state"].keys()
    for p, w in want["state"].items():
        g = got["state"][p]
        assert g.dtype == w.dtype, p
        if exact:
            assert torch.equal(g, w), p
        else:
            torch.testing.assert_close(g, w, msg=lambda m: f"{p}: {m}")
    if exact:
        assert got["losses"] == want["losses"]
    else:
        torch.testing.assert_close(torch.tensor(got["losses"]),
                                   torch.tensor(want["losses"]))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("launcher", ["train", "serve"])
@pytest.mark.parametrize("name,ranks", [("pod", 256), ("multipod", 512)])
def test_production_mesh_without_distributed_raises(launcher, name, ranks):
    argv = ["--arch", "granite-3-8b", "--preset", "smoke", "--device", "cpu",
            "--mesh", name]
    main = train.main if launcher == "train" else serve.main
    with pytest.raises(ValueError, match=f"{ranks} ranks"):
        main(argv)


@pytest.mark.parametrize("var", lmesh.TORCHRUN_VARS)
def test_distributed_without_the_environment_names_the_variable(
        var, monkeypatch):
    for v in lmesh.TORCHRUN_VARS:
        monkeypatch.setenv(v, "0" if v != "MASTER_ADDR" else "127.0.0.1")
    monkeypatch.delenv(var)
    with pytest.raises(RuntimeError, match=var):
        train.main(cli("granite-3-8b") + ["--distributed"])


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank gloo group in this process and its host mesh, (1, 1)."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        yield lmesh.make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _wrapper_calls():
    """Each kernel wrapper, called on CPU operands of its own shapes, with
    one operand made a DTensor by ``dt``."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    q, k = torch.randn(1, 2, 16, 8), torch.randn(1, 1, 16, 8)
    mant = torch.zeros(64, 64, dtype=torch.int8)
    exp = torch.zeros(2, 2, dtype=torch.int8)
    a_buf = torch.zeros(128, 64, dtype=torch.bfloat16)
    b_buf = torch.zeros(256, 64, dtype=torch.bfloat16)
    return {
        "flash_attention": lambda dt: fa.flash_attention(
            dt(q), k, k, q_chunk=16, kv_chunk=16),
        "bfp_matmul": lambda dt: bm.bfp_matmul(a, dt(b)),
        "quantize_operand": lambda dt: bm.quantize_operand(dt(a), 128),
        "bfp_quantize": lambda dt: bq.bfp_quantize(dt(a)),
        "dequantize_operand": lambda dt: bq.dequantize_operand(
            dt(mant), exp, 128),
        "bfp_matmul_packed": lambda dt: bq.bfp_matmul_packed(
            mant, exp, dt(mant), exp),
        "gemm_tn": lambda dt: bc.gemm_tn(dt(a_buf), b_buf, 64, 64),
        "bfp_dense": lambda dt: ops.bfp_dense(dt(a), b),
    }


@pytest.mark.parametrize("wrapper", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_a_dtensor(wrapper, one_rank_mesh):
    from torch.distributed.tensor import DTensor, Replicate
    call = _wrapper_calls()[wrapper]
    call(lambda t: t)                    # the plain operands run

    def dt(t):
        return DTensor.from_local(t, one_rank_mesh, [Replicate()] * 2)
    with pytest.raises(TypeError, match=wrapper):
        call(dt)


# --------------------------------------------------------------------------
# one gloo rank in this process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_on_a_one_rank_host_mesh_is_the_plain_launcher(arch,
                                                             one_rank_mesh):
    want = summary(run_train(arch))
    got = summary(run_train(arch, mesh=one_rank_mesh), one_rank_mesh)
    assert got["moved"] == []
    assert_same_run(got, want, exact=True)


# --------------------------------------------------------------------------
# four gloo ranks, each a process, one launch
# --------------------------------------------------------------------------

# the reference's launcher path (repro/launch/train.py:64-80) on its own
# functions, on four CPU devices, for granite-3-8b SMOKE duplex: the initial
# state, then each step's metrics and the final state, as numpy
JAX = r"""
import dataclasses as dc, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import duplex as dx
from repro.distributed import ctx, sharding as sh
from repro.launch.cells import activation_rules, duplex_tcfg
from repro.models import layers as L, registry
from repro.train import train_step as ts
d = sys.argv[1]
assert len(jax.devices()) == 4
entry = registry.get("granite-3-8b")
cfg = entry.config("smoke")
policy = L.Policy(compute_dtype=jnp.float32)
tcfg = dc.replace(duplex_tcfg(cfg), backbone_dtype=jnp.float32,
                  duplex=dx.DuplexConfig(n_blocks=2, d_branch=32,
                                         pool_factor=4, branch_heads=2,
                                         bfp=L.BFPPolicy(enabled=True,
                                                         group=(3, 3))))
def flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flat(tree[key], f"{pre}{key}/").items()}
    return {pre[:-1]: np.asarray(tree)}
batches = np.load(f"{d}/batches.npz")
# make_host_mesh()'s (4, 1), built as jax.sharding.Mesh: jax.make_mesh's
# axes are Explicit under jax 0.9, and the embedding's gather under
# ``with mesh`` then raises ShardingTypeError
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(4, 1),
                         ("data", "model"))
with mesh, ctx.activation_sharding(mesh, activation_rules(cfg, mesh)):
    specs = sh.to_named(sh.state_pspecs(jax.eval_shape(
        lambda k: ts.init_state(k, entry, cfg, tcfg, policy),
        jax.random.PRNGKey(0)), mesh), mesh)
    step = jax.jit(ts.make_train_step(entry, cfg, tcfg, policy),
                   donate_argnums=0)
    st = ts.init_state(jax.random.PRNGKey(0), entry, cfg, tcfg, policy)
    out = {"init/" + k: v for k, v in flat(st).items()}
    st = jax.device_put(st, specs)
    for i in range(2):
        st, m = step(st, {k: jnp.asarray(batches[f"{k}{i}"])
                          for k in ("tokens", "labels")})
        out.update({f"metrics{i}/{k}": np.asarray(v) for k, v in m.items()})
    out.update({"final/" + k: v for k, v in flat(st).items()})
np.savez(f"{d}/jax.tmp.npz", **out)
import os; os.rename(f"{d}/jax.tmp.npz", f"{d}/jax.npz")
"""

RANK = r"""
import json, os, sys, time
from pathlib import Path
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
d, rank, tests, ports = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    json.loads(sys.argv[4])
sys.path.insert(0, tests)
import test_torch_launch_mesh as T
from repro_torch import bridge
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import cells, mesh as lmesh, train
from repro_torch.train import train_step as ts
from repro_torch.utils import tree_flatten, tree_unflatten, whole
os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                  MASTER_ADDR="127.0.0.1")
res = {}
for arch, port in zip(T.CLI_HOST, ports):
    os.environ["MASTER_PORT"] = str(port)
    out = train.main(T.cli(arch, T.FOUR_STEPS) +
                     ["--distributed", "--mesh", "host"])
    assert not dist.is_initialized(), "the launcher left its group"
    res[f"cli/{arch}"] = T.summary_cli(out)
os.environ["MASTER_PORT"] = str(ports[-1])
lmesh.init_distributed("cpu")
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch, flash in T.TRAIN_22:
        res[f"train/{arch}"] = T.summary(
            T.run_train(arch, use_flash=flash, steps=T.FOUR_STEPS,
                        mesh=mesh), mesh)
    for arch, prompt in T.SERVE_22:
        res[f"serve/{arch}"] = T.run_serve(arch, prompt, mesh)["tokens"]
    T.run_train("granite-3-8b", steps=2, mesh=mesh, ckpt_dir=d / "mesh_ck")
    res["ckpt/plain_on_four"] = T.summary(T.run_train(
        "granite-3-8b", steps=4, mesh=mesh, ckpt_dir=d / "plain_ck"), mesh)
    # against JAX: its initial state and batches, placed as the launcher
    # places them on a (4, 1) host mesh
    hmesh = lmesh.make_host_mesh(device_type="cpu")
    for _ in range(600):
        if (d / "jax.npz").exists():
            break
        time.sleep(0.5)
    ref = dict(np.load(d / "jax.npz"))
    batches = np.load(d / "batches.npz")
    entry, cfg, tcfg, policy = T.build("granite-3-8b")
    state = bridge.state_from_jax(tree_unflatten(
        {k[5:]: v for k, v in ref.items() if k.startswith("init/")}), "cpu")
    state = sh.device_put(state, sh.to_named(
        sh.state_pspecs(state, hmesh), hmesh))
    step = train.loop_step(ts.make_train_step(entry, cfg, tcfg, policy),
                           "cpu", None, hmesh)
    got = {}
    with ctx.activation_sharding(hmesh, cells.activation_rules(cfg, hmesh)):
        for i in range(2):
            state, m = step(state, {k: batches[f"{k}{i}"]
                                    for k in ("tokens", "labels")})
            got.update({f"metrics{i}/{k}": whole(v) for k, v in m.items()})
    got.update({"final/" + p: whole(t) for p, t in tree_flatten(state)})
    res["jax"] = got
finally:
    dist.destroy_process_group()
if rank == 0:
    torch.save(res, d / "res.pt")
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One launch of four gloo ranks running every four-rank case, beside
    the JAX subprocess; returns rank 0's results and the directory."""
    d = tmp_path_factory.mktemp("four")
    rng = np.random.default_rng(5)
    np.savez(d / "batches.npz", **{
        f"{k}{i}": rng.integers(0, registry.get("granite-3-8b").smoke.vocab,
                                (BATCH, SEQ)).astype(np.int32)
        for i in range(2) for k in ("tokens", "labels")})
    run_train("granite-3-8b", steps=2, ckpt_dir=d / "plain_ck")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    jax_env = {**env, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                            "--xla_cpu_multi_thread_eigen=false"}
    ports = json.dumps([free_port() for _ in range(len(CLI_HOST) + 1)])
    procs = [subprocess.Popen([sys.executable, "-c", JAX, str(d)],
                              env=jax_env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", RANK, str(d), str(r), str(ROOT / "tests"),
         ports], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        failed = []
        for name, p in zip(["jax"] + [f"rank {r}" for r in range(4)], procs):
            _, err = p.communicate(timeout=600)
            if p.returncode != 0:
                failed.append(f"{name}: {err[-3000:]}")
        assert not failed, "\n".join(failed)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return torch.load(d / "res.pt"), d


@pytest.mark.parametrize("arch", CLI_HOST)
def test_train_cli_on_four_ranks_host_mesh(arch, four_ranks):
    res, _ = four_ranks
    got = res[f"cli/{arch}"]
    assert got["mesh"] == (4, 1) and got["moved"] == []
    assert_same_run(got, summary(train.main(cli(arch, FOUR_STEPS))))


@pytest.mark.parametrize("arch,use_flash", TRAIN_22)
def test_train_on_a_2x2_mesh_is_the_plain_run(arch, use_flash, four_ranks):
    res, _ = four_ranks
    got = res[f"train/{arch}"]
    assert got["moved"] == []
    before = fa.flash_attention.launches
    want = summary(run_train(arch, use_flash=use_flash, steps=FOUR_STEPS))
    assert fa.flash_attention.launches == before     # the CPU's plain version
    assert_same_run(got, want)


@pytest.mark.parametrize("arch,prompt", SERVE_22)
def test_serve_on_a_2x2_mesh_gives_the_plain_tokens(arch, prompt,
                                                    four_ranks):
    res, _ = four_ranks
    want = run_serve(arch, prompt)["tokens"]
    assert torch.equal(res[f"serve/{arch}"], want)


def test_checkpoint_saved_on_four_ranks_resumes_on_one(four_ranks):
    _, d = four_ranks
    straight = summary(run_train("granite-3-8b", steps=4))
    resumed = summary(run_train("granite-3-8b", steps=4,
                                ckpt_dir=d / "mesh_ck"))
    assert resumed["resumed_from"] == 2
    assert_same_run(resumed, {**straight, "losses": straight["losses"][2:]})


def test_plain_checkpoint_resumes_on_four_ranks(four_ranks):
    res, _ = four_ranks
    got = res["ckpt/plain_on_four"]
    assert got["resumed_from"] == 2 and got["moved"] == []
    straight = summary(run_train("granite-3-8b", steps=4))
    assert_same_run(got, {**straight, "losses": straight["losses"][2:]})


def test_four_ranks_step_as_jax_on_four_devices(four_ranks):
    """Tolerances of ``tests/test_torch_train_step.py``: rtol 1e-5, atol
    1e-6, for the metrics and every leaf of the new state."""
    res, d = four_ranks
    ref = dict(np.load(d / "jax.npz"))
    got = res["jax"]
    want = {k: v for k, v in ref.items() if not k.startswith("init/")}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
