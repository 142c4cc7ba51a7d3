"""repro_torch stands alone: it imports without JAX, without the JAX
package and without msgpack (the card's machine has none; the checkpointer
carries its own encoder), and its sources (and chip_smoke.py) name none of
them, nor a library attention or torch.compile."""
import ast
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_and_repro_masked():
    """Every module imports with jax, repro and msgpack masked."""
    mods = _modules()
    for m in ("flash_attention", "ops", "bfp_matmul", "bfp_quant",
              "bfp_common", "ref"):
        assert f"repro_torch.kernels.{m}" in mods
    for m in ("optim.schedule", "ckpt.checkpoint", "ckpt.msgpack_lite",
              "bench.common", "bench.table2_accuracy",
              "bench.fig21_ablations", "bench.bfp_fidelity",
              "examples.train_duplex_lm", "models.moe",
              "configs.granite_moe_1b", "configs.llama4_maverick",
              "models.ssm", "configs.mamba2_780m", "models.encdec",
              "configs.whisper_base", "configs.llama32_vision_90b",
              "train.serve_step", "launch.serve", "examples.quickstart",
              "models.hybrid", "configs.recurrentgemma_9b"):
        assert f"repro_torch.{m}" in mods
    masked = ("jax", "repro", "msgpack")
    code = (
        "import sys\n"
        f"for m in {masked!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {masked!r}]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _sources():
    return sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + \
        sorted(PKG.rglob("*.cuh")) + \
        [ROOT / "chip_smoke.py"]


FORBIDDEN = [
    (r"^\s*import\s+jax\b|^\s*from\s+jax\b", "imports jax"),
    (r"^\s*import\s+repro\.|^\s*from\s+repro\.|^\s*import\s+repro\s*$"
     r"|^\s*from\s+repro\s+import", "imports the JAX package"),
    (r"^\s*import\s+msgpack\b|^\s*from\s+msgpack\b", "imports msgpack"),
    (r"scaled_dot_product_attention|flex_attention", "library attention"),
    (r"torch\.compile", "torch.compile"),
]


@pytest.mark.parametrize("pattern,what", FORBIDDEN,
                         ids=[w for _, w in FORBIDDEN])
def test_sources_name_no_forbidden_import_or_call(pattern, what):
    rx = re.compile(pattern, re.M)
    hits = []
    for path in _sources():
        if path.name == "chip_smoke.py" and what in ("library attention",
                                                     "torch.compile"):
            continue    # chip_smoke times the library call as a yardstick
        if rx.search(path.read_text()):
            hits.append(str(path.relative_to(ROOT)))
    assert not hits, f"{what}: {hits}"


def test_chip_smoke_calls_library_attention_only_to_time_it():
    """chip_smoke names the library attention (SDPA, and flex_attention
    with the torch.compile it needs) only inside ``library_attention``,
    the yardstick it times beside the kernel."""
    text = (ROOT / "chip_smoke.py").read_text()
    fn = next(n for n in ast.parse(text).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "library_attention")
    rx = re.compile(r"scaled_dot_product_attention|flex_attention|"
                    r"torch\.compile")
    lines = [i for i, line in enumerate(text.splitlines(), 1)
             if rx.search(line)]
    assert lines
    outside = [i for i in lines if not fn.lineno <= i <= fn.end_lineno]
    assert not outside, outside
