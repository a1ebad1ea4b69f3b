"""The port's roofline (``roofline/analysis.py``) against the reference's
(``src/repro/roofline/analysis.py``): ``model_flops`` equals the
reference's on a record of every arch × shape × production mesh; the
three terms, the bottleneck and the MFU bound follow the formula at the
H100's rates; ``load_all`` merges a ``--costing`` record's counts into
the plain record."""

import json

import pytest

from repro.configs import get_config as jax_config
from repro.roofline import analysis as jax_analysis
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.dryrun import SHAPE_NAMES
from repro_torch.roofline import analysis


def _record(arch, shape, devices, **kw):
    cfg = get_config(arch)
    mode = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode",
            "long_500k": "decode"}[shape]
    rec = {"arch": cfg.name, "shape": shape, "mesh": "pod" if devices == 256 else "multipod",
           "mode": mode, "devices": devices, "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("devices", [256, 512])
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape, devices):
    rec = _record(arch, shape, devices)
    assert rec["active_params"] == jax_config(arch).active_param_count()
    assert analysis.model_flops(rec) == jax_analysis.model_flops(rec)


def test_h100_rates():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW) == (989e12, 3.35e12)
    assert (analysis.NVLINK_BW, analysis.IB_BW) == (450e9, 50e9)


@pytest.mark.parametrize("devices,link", [(512, 50e9), (256, 50e9), (8, 450e9)])
def test_terms_bottleneck_and_mfu_follow_the_formula(devices, link):
    coll = {"all-gather": 3e9, "all-reduce": 2e9, "reduce-scatter": 1e9, "all-to-all": 0,
            "collective-permute": 0, "count": 77}
    rec = _record("yi_9b", "train_4k", devices, flops=4.2e14, bytes_accessed=6.5e12,
                  collectives=coll)
    r = analysis.analyze(rec)
    assert r.compute_s == 4.2e14 / 989e12
    assert r.memory_s == 6.5e12 / 3.35e12
    assert r.collective_s == 6e9 / link
    terms = {"compute": r.compute_s, "memory": r.memory_s, "collective": r.collective_s}
    assert r.bottleneck == max(terms, key=terms.get)
    assert r.step_s == max(terms.values())
    mf = analysis.model_flops(rec)
    assert r.useful_ratio == mf / 4.2e14
    assert r.mfu == (mf / r.step_s) / 989e12
    assert r.row().startswith(f"| {rec['arch']} | train_4k |")


def test_skipped_and_failed_records_have_no_roofline():
    assert analysis.analyze({"skipped": True}) is None
    assert analysis.analyze({"error": "boom"}) is None


def test_load_all_merges_the_costing_record(tmp_path):
    coll = {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 3, "all-to-all": 0,
            "collective-permute": 0, "count": 3}
    plain = _record("olmo_1b", "prefill_32k", 256, flops=1.0, bytes_accessed=1.0,
                    collectives=coll, temp_size_in_bytes=123)
    cost = dict(plain, flops=9e12, bytes_accessed=8e11,
                collectives=dict(coll, **{"all-reduce": 7e9}), temp_size_in_bytes=None)
    for sub, rec in (("pod", plain), ("pod_cost", cost)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "olmo-1b__prefill_32k.json").write_text(json.dumps(rec))
    (tmp_path / "pod" / "olmo-1b__long_500k.json").write_text(json.dumps({"skipped": True}))
    rows = analysis.load_all(str(tmp_path), "pod")
    assert len(rows) == 1
    r = rows[0]
    assert r.hlo_flops == 9e12 and r.memory_s == 8e11 / 3.35e12
    assert r.collective_s == (7e9 + 4) / 50e9
    assert r.raw["temp_size_in_bytes"] == 123
    assert analysis.table(rows).count("\n") == 2
