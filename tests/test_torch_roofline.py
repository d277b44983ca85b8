"""The roofline's pure costing (``repro_torch.launch.roofline``) against
``repro.launch.roofline``: the three-term arithmetic at the H100's data
sheet peaks, ``model_flops`` equal to the reference's for all ten
published configs on every shape cell, and ``plan_summary`` equal to the
reference's dict on the same ``RoundPlan`` JSON (a synthetic plan, and a
plan the port measured on gnm n = 512)."""
import pytest

import repro.configs.base as ref_configs
import repro.core.plan as ref_plan
import repro.launch.roofline as ref_roofline
import repro_torch.configs.base as port_configs
import repro_torch.core.plan as port_plan
from repro.launch.shapes import SHAPES
from repro_torch.core.distributed import build_dist_graph
from repro_torch.core.distributed_sharded import plan_sharded_msf
from repro_torch.data import generators
from repro_torch.launch import roofline
from repro_torch.launch.roofline import RooflineTerms


def test_roofline_terms_math():
    t = RooflineTerms(flops=989e12, bytes_accessed=3.35e12,
                      collective_bytes=450e9, chips=8)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)
    assert t.step_time_s == pytest.approx(1.0)
    t2 = RooflineTerms(flops=1e12, bytes_accessed=3.35e12,
                       collective_bytes=0, chips=1)
    assert t2.dominant == "memory"
    assert t2.compute_fraction < 0.01
    t3 = RooflineTerms(flops=0, bytes_accessed=0, collective_bytes=0,
                       chips=1)
    assert t3.compute_fraction == 0.0
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_as_dict_has_the_reference_keys():
    args = dict(flops=2e12, bytes_accessed=1e9, collective_bytes=3e8,
                chips=4)
    got = RooflineTerms(**args).as_dict()
    ref = ref_roofline.RooflineTerms(**args).as_dict()
    assert list(got) == list(ref)
    assert got["dominant"] == "compute" and got["flops"] == 2e12


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    ref_cfg = ref_configs.get_arch(arch).config
    port_cfg = port_configs.get_arch(arch).config
    for shape in SHAPES.values():
        for backward in (shape["kind"] == "train", False):
            assert roofline.model_flops(port_cfg, shape, backward) == \
                ref_roofline.model_flops(ref_cfg, shape, backward)


def _summaries(text):
    got = roofline.plan_summary(port_plan.RoundPlan.from_json(text))
    ref = ref_roofline.plan_summary(ref_plan.RoundPlan.from_json(text))
    return got, ref


def test_plan_summary_equal_reference_on_a_synthetic_plan():
    for algorithm in ("boruvka", "filter_boruvka"):
        plan = port_plan.synthetic_plan(4096, 40000, 8, algorithm=algorithm)
        got, ref = _summaries(plan.to_json())
        assert got == ref
        assert got["rounds"] == plan.num_rounds


def test_plan_summary_equal_reference_on_a_measured_plan():
    u, v, w, n = generators.gnm(512, 2048, seed=7)
    g, _ = build_dist_graph(u, v, w, n, 8, device="cpu")
    plan = plan_sharded_msf(g, n, 8)
    got, ref = _summaries(plan.to_json())
    assert got == ref
    assert got["ghost"] == 1.0 and got["cap_edge_shrink"] > 1.0
