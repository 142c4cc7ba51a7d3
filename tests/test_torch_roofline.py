"""The roofline (``repro_torch.bench.roofline``) against the reference's
(``benchmarks/roofline.py`` and ``benchmarks/run.py``'s ``_roofline_rows``).

* ``param_counts`` of the ten archs (a ``meta`` init against JAX's
  ``eval_shape``): total and active, value and type (the MoE archs'
  ``active`` is a float on both sides);
* ``model_flops`` of every cell of ``registry.cells()``;
* ``roofline_row`` on the same record, float for float, with the
  reference's three constants set to the port's H100 ones: a decode
  (granite-3-8b), a prefill (mamba2-780m) and a train (granite-moe-1b-
  a400m) record of the port, each traced per device at SMOKE by
  ``dryrun.trace_cell`` on a (2, 2) mesh over torch's in-process ``fake``
  group of 4 ranks, and a synthetic record whose ``collectives`` hold a
  ``counts`` entry; a whole-cell record (``partitioned: false``) raises;
* ``build_table``, ``markdown_table``, ``main`` and ``roofline_rows`` on a
  directory of records (ok, skipped, error, another variant, another
  mesh, a ``.trace.txt`` beside them), and ``roofline_rows`` without one.
"""
import dataclasses as dc
import functools
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import roofline as ref  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.bench import roofline  # noqa: E402
from repro_torch.configs.common import ShapeSpec  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.models import layers as TL, registry  # noqa: E402

ARCHS = list(registry.ARCHS)
# (arch, shape name, the SMOKE ShapeSpec traced) of the three records
TRACED = [
    ("granite-3-8b", "decode_32k", ShapeSpec("decode_32k", 20, 2, "decode")),
    ("mamba2-780m", "prefill_32k",
     ShapeSpec("prefill_32k", 16, 2, "prefill")),
    ("granite-moe-1b-a400m", "train_4k", ShapeSpec("train_4k", 16, 2,
                                                   "train")),
]


@functools.cache
def counts(arch: str) -> dict:
    return roofline.param_counts(arch)


@functools.cache
def ref_counts(arch: str) -> dict:
    return ref.param_counts(arch)


@pytest.fixture
def h100(monkeypatch):
    """The reference's constants set to the port's."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref, name, getattr(roofline, name))


@pytest.fixture(scope="module")
def records():
    """The three ``TRACED`` records of the port, traced per device on a
    (2, 2) ``DeviceMesh`` over a ``fake`` group of 4 ranks (the registry at
    SMOKE, f32 compute; the group destroyed and the registry put back
    after), with ``arch``, ``shape``, ``mesh``, ``mode``, ``variant`` and
    ``status`` added as ``dryrun.run_cell`` adds them; and ``whole``, one
    traced whole on the abstract (2, 2) layout."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name, entry in list(registry.ARCHS.items()):
                mp.setitem(registry.ARCHS, name,
                           dc.replace(entry, full=entry.smoke))
            mp.setattr(cells, "POLICY", TL.Policy(compute_dtype=torch.float32))
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            for arch, name, spec in TRACED:
                rec = dryrun.trace_cell(arch, spec, mesh)
                rec.pop("trace")
                rec.pop("trace_global")
                out[spec.mode] = {"arch": arch, "shape": name, "mesh": "pod",
                                  "mode": spec.mode, "variant": "baseline",
                                  "status": "ok", **rec}
            whole = dryrun.trace_cell(
                "granite-3-8b", TRACED[0][2],
                sh.AbstractMesh((2, 2), ("data", "model")))
            whole.pop("trace")
            out["whole"] = {"arch": "granite-3-8b", "shape": "decode_32k",
                            "mesh": "pod", "status": "ok", **whole}
    finally:
        dist.destroy_process_group()
    return out


def synthetic() -> dict:
    """A per-device record with a ``counts`` entry in ``collectives`` and a
    collective term that bounds the step."""
    return {"arch": "llama4-maverick-400b-a17b", "shape": "train_4k",
            "mesh": "pod", "status": "ok", "partitioned": True,
            "n_devices": 256,
            "cost": {"dot_flops": 3.1e14, "traffic_bytes": 7.7e11},
            "collectives": {"all-gather": 4.1e10, "all-reduce": 3e9,
                            "total": 4.4e10,
                            "counts": {"all-gather": 812, "all-reduce": 9}},
            "memory": {"temp_bytes": 5.2e10, "argument_bytes": 1.9e10}}


def same(got, want) -> None:
    """Equal values of equal types, keys in the same order."""
    assert got == want
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, list):
        for g, w in zip(got, want):
            same(g, w)
    else:
        assert type(got) is type(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    same(counts(arch), ref_counts(arch))


@pytest.mark.parametrize("arch,shape", [
    (a, s.name) for a, s, _ in registry.cells()])
def test_model_flops_equals_the_reference(arch, shape):
    assert list(registry.ARCHS) == list(jregistry.ARCHS)
    same(roofline.model_flops(arch, shape, counts(arch)),
         ref.model_flops(arch, shape, ref_counts(arch)))


@pytest.mark.parametrize("which", ["decode", "prefill", "train",
                                   "synthetic"])
def test_roofline_row_equals_the_reference(which, records, h100):
    rec = synthetic() if which == "synthetic" else records[which]
    assert rec["partitioned"] is True
    row = roofline.roofline_row(rec, counts(rec["arch"]))
    same(row, ref.roofline_row(rec, ref_counts(rec["arch"])))
    terms = roofline.roofline_terms(rec["cost"]["dot_flops"],
                                    rec["cost"]["traffic_bytes"],
                                    rec["collectives"]["total"])
    assert row["step_s_bound"] == max(terms.values()) > 0
    assert row["bottleneck"] == max(terms, key=terms.get)
    if which == "synthetic":
        assert row["bottleneck"] == "collective"


def test_roofline_row_refuses_a_whole_cell_record(records):
    whole = records["whole"]
    assert whole["partitioned"] is False
    with pytest.raises(ValueError, match=r"granite-3-8b decode_32k.*"
                                         r"DeviceMesh"):
        roofline.roofline_row(whole, counts("granite-3-8b"))
    with pytest.raises(ValueError, match="partitioned"):
        roofline.roofline_row({**records["decode"], "partitioned": False},
                              counts("granite-3-8b"))


def test_terms_are_the_h100_peaks():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.NVLINK_BW) == (989e12, 3.35e12, 50e9, 450e9)
    assert roofline.roofline_terms(989e12, 3.35e12 * 2) == {
        "compute": 1.0, "memory": 2.0, "collective": 0.0}


def write_records(d: Path, records: dict) -> Path:
    """A directory of records as ``dryrun.main`` names them: the three
    traced ones, a skipped long_500k cell, an error, a tuned variant and a
    multipod copy, and a ``.trace.txt`` beside them."""
    d.mkdir(parents=True, exist_ok=True)
    recs = [records[m] for m in ("decode", "prefill", "train")]
    recs.append(dryrun.run_cell("granite-3-8b", "long_500k", False, d))
    recs.append({"arch": "qwen2-72b", "shape": "train_4k", "mesh": "pod",
                 "status": "error", "error": "RuntimeError: boom",
                 "traceback": "..."})
    recs.append({**records["train"], "variant": "tuned"})
    recs.append({**records["decode"], "mesh": "multipod", "n_devices": 512})
    for rec in recs:
        suffix = "" if rec.get("variant", "baseline") == "baseline" \
            else f"__{rec['variant']}"
        (d / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
         ).write_text(json.dumps(rec, indent=2))
    (d / "granite-3-8b__decode_32k__pod.trace.txt").write_text(
        "not a record\n")
    return d


@pytest.mark.parametrize("mesh,variant", [("pod", "baseline"),
                                          ("multipod", "baseline"),
                                          ("pod", "tuned")])
def test_build_and_markdown_table_equal_the_reference(mesh, variant, records,
                                                      h100, tmp_path):
    d = write_records(tmp_path / "dryrun", records)
    rows = roofline.build_table(str(d), mesh, variant)
    same(rows, ref.build_table(str(d), mesh, variant))
    assert rows
    assert roofline.markdown_table(rows) == ref.markdown_table(rows)
    if mesh == "pod" and variant == "baseline":
        assert [r["bottleneck"] for r in rows
                if r["bottleneck"] in ("SKIP", "ERROR")] == ["SKIP", "ERROR"]


def test_main_equals_the_reference(records, h100, tmp_path, monkeypatch,
                                   capsys):
    d = write_records(tmp_path / "dryrun", records)
    out = {}
    for side, mod in (("port", roofline), ("ref", ref)):
        js = tmp_path / side / "roofline.json"
        monkeypatch.setattr(sys, "argv", ["roofline", "--dryrun-dir", str(d),
                                          "--json-out", str(js)])
        mod.main()
        out[side] = (capsys.readouterr().out, js.read_text())
    assert out["port"] == out["ref"]
    assert "| SKIP |" in out["port"][0] and "| ERROR |" in out["port"][0]


def test_roofline_rows_equal_the_reference(records, h100, tmp_path,
                                           monkeypatch):
    from benchmarks import run
    monkeypatch.chdir(tmp_path)
    assert roofline.roofline_rows() == run._roofline_rows() == \
        ["roofline/skipped,0,no experiments/dryrun artifacts"]
    write_records(tmp_path / "experiments" / "dryrun", records)
    rows = roofline.roofline_rows()
    assert rows == run._roofline_rows()
    assert len(rows) == 5
    assert rows[1] == "roofline/granite-3-8b/long_500k,0,SKIP"
    assert rows[4] == "roofline/qwen2-72b/train_4k,0,ERROR"
