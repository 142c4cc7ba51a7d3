"""The port's launcher: a few smoke steps on the CPU, and no silent CPU
fallback when a card is asked for and absent."""
import math

import pytest
import torch

from repro_torch.kernels import bfp_matmul as bm, bfp_quant as bq, \
    flash_attention as tf
from repro_torch.launch import train


def test_smoke_steps_on_cpu(capsys):
    out = train.main(["--arch", "granite-3-8b", "--preset", "smoke",
                      "--steps", "3", "--seq", "32", "--batch", "4",
                      "--device", "cpu", "--log-every", "1"])
    report = out["report"]
    assert report.steps_run == 3
    assert [m["step"] for m in report.metrics_history] == [0, 1, 2]
    assert all(math.isfinite(m["loss"]) for m in report.metrics_history)
    assert out["backbone_checksum"][0] == out["backbone_checksum"][1]
    assert out["branch_max_abs_change"] > 0
    assert int(report.state["step"]) == 3
    assert "finished 3 steps" in capsys.readouterr().out


def test_full_preset_turns_on_flash():
    _, cfg, tcfg, policy = train.build("granite-3-8b", "full")
    assert cfg.use_flash and policy.compute_dtype == torch.bfloat16
    assert tcfg.backbone_dtype == torch.bfloat16
    assert (tcfg.duplex.d_branch, tcfg.duplex.n_blocks,
            tcfg.duplex.pool_factor, tcfg.duplex.branch_heads) == (512, 8, 16, 4)
    assert tcfg.duplex.bfp.group == (32, 32)


def test_cpu_path_launches_no_kernel():
    before = tf.flash_attention.launches
    train.main(["--arch", "qwen2-72b", "--preset", "smoke", "--steps", "1",
                "--seq", "16", "--batch", "2", "--device", "cpu"])
    assert tf.flash_attention.launches == before


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "granite-3-8b", "--preset", "smoke",
                    "--steps", "1"])


def test_full_mode_smoke_steps_on_cpu(capsys):
    out = train.main(["--arch", "qwen2-72b", "--preset", "smoke", "--mode",
                      "full", "--steps", "3", "--seq", "32", "--batch", "4",
                      "--device", "cpu", "--log-every", "1"])
    report = out["report"]
    assert report.steps_run == 3 and report.resumed_from is None
    assert set(report.state) == {"step", "backbone", "opt"}
    assert all(math.isfinite(m["loss"]) for m in report.metrics_history)
    before, after = out["backbone_checksum"]
    assert before != after                     # the backbone trains
    assert out["branch_max_abs_change"] is None
    assert "finished 3 steps (fresh start)" in capsys.readouterr().out


def test_full_mode_keeps_flash_off_and_f32_params():
    _, cfg, tcfg, policy = train.build("granite-3-8b", "full", "full")
    assert not cfg.use_flash and policy.compute_dtype == torch.bfloat16
    assert tcfg.mode == "full" and tcfg.lr == 1e-3
    assert tcfg.opt.momentum == 0.9            # SGD, the reference's default


@pytest.mark.cuda
def test_cuda_duplex_step_matches_cpu():
    """One duplex step on the card (flash kernel, f32) against the same step
    on the CPU (plain version).  BFP off: a BFP group could round the other
    way under the card's summation order and move an operand by a whole
    group step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import dataclasses as dc

    from repro_torch.models import layers as L
    from repro_torch.train import train_step as ts
    from repro_torch.utils import tree_flatten, tree_map

    entry, cfg, tcfg, policy = train.build("granite-3-8b", "smoke")
    cfg = dc.replace(cfg, d_model=128, n_heads=2, n_kv=1, head_dim=64,
                     use_flash=True)
    tcfg = dc.replace(tcfg, duplex=dc.replace(tcfg.duplex,
                                              bfp=L.BFPPolicy(False)))
    state = ts.init_state(torch.Generator().manual_seed(0), entry, cfg, tcfg,
                          policy)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    cpu_state, cpu_m = step(state, batch)
    before = tf.flash_attention.launches
    gpu_state, gpu_m = step(tree_map(lambda t: t.cuda(), state),
                            {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert tf.flash_attention.launches == before + cfg.n_rep
    torch.testing.assert_close(gpu_m["loss"].cpu(), cpu_m["loss"],
                               rtol=1e-4, atol=1e-5)
    for (p, g), (_, c) in zip(tree_flatten(gpu_state["branch"]),
                              tree_flatten(cpu_state["branch"])):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5,
                                   msg=p)


@pytest.mark.parametrize("arch", ["gemma2-9b", "starcoder2-7b"])
def test_local_attention_archs_step_on_cpu(arch):
    """gemma2 (local + global layers) and starcoder2 through the launcher:
    duplex smoke steps on the CPU, no kernel launched."""
    before = tf.flash_attention.launches
    out = train.main(["--arch", arch, "--preset", "smoke", "--steps", "2",
                      "--seq", "32", "--batch", "2", "--device", "cpu",
                      "--log-every", "1"])
    report = out["report"]
    assert report.steps_run == 2
    assert all(math.isfinite(m["loss"]) for m in report.metrics_history)
    assert out["backbone_checksum"][0] == out["backbone_checksum"][1]
    assert out["branch_max_abs_change"] > 0
    assert tf.flash_attention.launches == before


@pytest.mark.parametrize(
    "arch,mode", [("mamba2-780m", "duplex"), ("mamba2-780m", "full"),
                  ("recurrentgemma-9b", "duplex"),
                  ("recurrentgemma-9b", "full")],
    ids=["duplex", "full", "recurrentgemma-9b-duplex",
         "recurrentgemma-9b-full"])
def test_mamba2_steps_on_cpu_launch_no_kernel(arch, mode):
    """mamba2 (attention-free) and recurrentgemma (lru layers and windowed
    local ones, no ``attn`` layer) through the launcher on the CPU, in both
    modes: finite losses, the backbone frozen in duplex and trained in
    full mode, and no kernel launched (their steps reach none)."""
    counters = (tf.flash_attention, bm.bfp_matmul, bq.bfp_quantize,
                bq.bfp_matmul_packed)
    before = [f.launches for f in counters]
    out = train.main(["--arch", arch, "--preset", "smoke",
                      "--mode", mode, "--steps", "2", "--seq", "20",
                      "--batch", "2", "--device", "cpu", "--log-every", "1"])
    report = out["report"]
    assert report.steps_run == 2
    assert all(math.isfinite(m["loss"]) for m in report.metrics_history)
    bb_before, bb_after = out["backbone_checksum"]
    assert (bb_before == bb_after) == (mode == "duplex")
    assert [f.launches for f in counters] == before


def test_full_preset_of_mamba2():
    """``--preset full``: bf16 compute; flash is switched on in duplex mode
    but mamba2 has no ``attn`` layer, so nothing reaches it."""
    _, cfg, tcfg, policy = train.build("mamba2-780m", "full")
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_chunk) == \
        (48, 1536, 128, 256)
    assert all(s.kind == "ssd" for s in cfg.pattern + cfg.remainder)
    assert policy.compute_dtype == torch.bfloat16
    assert tcfg.backbone_dtype == torch.bfloat16


@pytest.mark.parametrize("arch,head_dim", [("gemma2-9b", 256),
                                           ("starcoder2-7b", 128)])
def test_full_preset_of_local_attention_archs(arch, head_dim, monkeypatch):
    """``--preset full`` turns flash on for duplex (the global layers, head
    dim 256 for gemma2) and leaves it off for full mode; asked for the card
    where there is none, the launcher raises before building anything."""
    _, cfg, _, policy = train.build(arch, "full")
    assert cfg.use_flash and cfg.head_dim == head_dim
    assert head_dim in tf.SUPPORTED_HEAD_DIMS
    assert policy.compute_dtype == torch.bfloat16
    assert not train.build(arch, "full", "full")[1].use_flash
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", arch, "--preset", "full", "--steps", "1"])


@pytest.mark.cuda
def test_cuda_gemma2_duplex_step_matches_cpu():
    """One duplex step of a gemma2-shaped model (local + global layers,
    softcaps, head dim 256) on the card against the same step on the CPU:
    the global layers launch the f32 flash kernel at d=256, the local
    layers run the windowed path.  BFP off, as in the test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import dataclasses as dc

    from repro_torch.models import layers as L
    from repro_torch.train import train_step as ts
    from repro_torch.utils import tree_flatten, tree_map

    entry, cfg, tcfg, policy = train.build("gemma2-9b", "smoke")
    cfg = dc.replace(cfg, d_model=128, n_heads=2, n_kv=1, head_dim=256,
                     use_flash=True)
    tcfg = dc.replace(tcfg, duplex=dc.replace(tcfg.duplex,
                                              bfp=L.BFPPolicy(False)))
    state = ts.init_state(torch.Generator().manual_seed(0), entry, cfg, tcfg,
                          policy)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    cpu_state, cpu_m = step(state, batch)
    before = tf.flash_attention.launches
    gpu_state, gpu_m = step(tree_map(lambda t: t.cuda(), state),
                            {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert tf.flash_attention.launches == before + cfg.n_rep
    torch.testing.assert_close(gpu_m["loss"].cpu(), cpu_m["loss"],
                               rtol=1e-4, atol=1e-5)
    for (p, g), (_, c) in zip(tree_flatten(gpu_state["branch"]),
                              tree_flatten(cpu_state["branch"])):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5,
                                   msg=p)


@pytest.mark.parametrize("mode", ["duplex", "full"])
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_frontend_archs_step_on_cpu(arch, mode, monkeypatch):
    """whisper (audio frames through the encoder) and llama-3.2-vision
    (image patch embeddings for its cross layers) through the launcher on
    the CPU, in both modes: every forward of the step is fed the run's one
    stub frontend, of ``frontend_shape``'s shape, in f32 under ``smoke``;
    finite losses, the backbone frozen in duplex and trained in full mode,
    and no kernel launched."""
    from repro_torch.models import registry

    entry = registry.get(arch)
    seen = []
    plain = entry.module.forward

    def forward(*args, **kw):
        seen.append(kw.get("frontend"))
        return plain(*args, **kw)

    monkeypatch.setattr(entry.module, "forward", forward)
    counters = (tf.flash_attention, bm.bfp_matmul, bq.bfp_quantize,
                bq.bfp_matmul_packed)
    before = [f.launches for f in counters]
    out = train.main(["--arch", arch, "--preset", "smoke", "--mode", mode,
                      "--steps", "2", "--seq", "16", "--batch", "2",
                      "--device", "cpu", "--log-every", "1"])
    report = out["report"]
    assert report.steps_run == 2
    assert all(math.isfinite(m["loss"]) for m in report.metrics_history)
    bb_before, bb_after = out["backbone_checksum"]
    assert (bb_before == bb_after) == (mode == "duplex")
    assert [f.launches for f in counters] == before
    fe = out["frontend"]
    shapes = entry.frontend_shape(entry.smoke, 2)
    assert {k: tuple(v.shape) for k, v in fe.items()} == shapes
    assert all(v.dtype == torch.float32 for v in fe.values())
    assert len(seen) == 2 and all(s is fe for s in seen)


def test_loop_step_casts_every_data_key_and_adds_the_frontend():
    """The loop's step function casts every key the data gives (a ``mask``
    too, which the loss reads) to long on the device, and adds the stub
    frontend after that cast, as given: a float frontend is not cast."""
    import numpy as np

    seen = []
    fe = {"frames": torch.randn(2, 3, 4)}
    step_fn = train.loop_step(lambda st, b: seen.append(b) or (st, {}),
                              "cpu", fe)
    rng = np.random.default_rng(0)
    data = {"tokens": rng.integers(0, 9, (2, 5), dtype=np.int32),
            "labels": rng.integers(0, 9, (2, 5), dtype=np.int32),
            "mask": np.ones((2, 5), np.float32)}
    step_fn(None, data)
    (batch,) = seen
    assert sorted(batch) == ["frontend", "labels", "mask", "tokens"]
    for k, v in data.items():
        assert batch[k].dtype == torch.int64
        assert torch.equal(batch[k], torch.as_tensor(v).long())
    assert batch["frontend"] is fe
    seen.clear()
    train.loop_step(lambda st, b: seen.append(b) or (st, {}), "cpu")(
        None, data)
    assert "frontend" not in seen[0]


def test_full_preset_of_whisper_keeps_the_encoder_off_flash():
    """``--preset full`` turns flash on for the decoder's ``attn`` layers
    (MHA, head dim 64) only: the encoder keeps the reference's
    ``use_flash=False`` (its 1500 frames do not tile by the 512-query
    chunk of the flash contract), and the cross layers never take flash.
    The stub frames are bf16, [B, 1500, 512]."""
    from repro_torch.models import transformer as tr

    entry, cfg, tcfg, policy = train.build("whisper-base", "full")
    assert cfg.use_flash and not cfg.encoder.use_flash
    assert [tr.attn_cfg_for(cfg, s).use_flash for s in cfg.pattern] == \
        [True, False]
    assert (cfg.n_heads, cfg.n_kv, cfg.head_dim) == (8, 8, 64)
    assert tcfg.duplex.n_blocks == 6 and tcfg.duplex.d_branch == 256
    fe = train.stub_frontend(entry, cfg, 2, policy.compute_dtype, "cpu")
    assert tuple(fe["frames"].shape) == (2, 1500, 512)
    assert fe["frames"].dtype == torch.bfloat16
    assert not train.build("whisper-base", "full", "full")[1].use_flash


@pytest.mark.cuda
def test_cuda_whisper_duplex_step_matches_cpu():
    """One duplex step of whisper SMOKE with stub frames on the card against
    the same step on the CPU: the decoder's ``attn`` layers launch the f32
    flash kernel (head dim 64), the encoder and the cross layers run the
    plain attention path.  BFP off, as in the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import dataclasses as dc

    from repro_torch.models import layers as L
    from repro_torch.train import train_step as ts
    from repro_torch.utils import tree_flatten, tree_map

    entry, cfg, tcfg, policy = train.build("whisper-base", "smoke")
    cfg = dc.replace(cfg, d_model=128, n_heads=2, n_kv=2, head_dim=64,
                     frontend_dim=128, use_flash=True,
                     encoder=dc.replace(cfg.encoder, d_model=128, n_heads=2,
                                        n_kv=2, head_dim=64))
    tcfg = dc.replace(tcfg, duplex=dc.replace(tcfg.duplex,
                                              bfp=L.BFPPolicy(False)))
    state = ts.init_state(torch.Generator().manual_seed(0), entry, cfg, tcfg,
                          policy)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "frontend": train.stub_frontend(entry, cfg, 2, torch.float32,
                                             "cpu")}
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    cpu_state, cpu_m = step(state, batch)
    before = tf.flash_attention.launches
    gpu_state, gpu_m = step(tree_map(lambda t: t.cuda(), state),
                            tree_map(lambda t: t.cuda(), batch))
    torch.cuda.synchronize()
    assert tf.flash_attention.launches == before + cfg.n_rep
    torch.testing.assert_close(gpu_m["loss"].cpu(), cpu_m["loss"],
                               rtol=1e-4, atol=1e-5)
    for (p, g), (_, c) in zip(tree_flatten(gpu_state["branch"]),
                              tree_flatten(cpu_state["branch"])):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5,
                                   msg=p)
