"""The port's roofline (``repro_torch.roofline.analysis``) against the JAX
package's: the model FLOPs of every applicable cell, the ring factors of
the collectives (records against the equivalent HLO lines), the report's
properties, and the H100 peaks it defaults to."""
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.roofline import analysis as ref
from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.launch import mesh
from repro_torch.roofline import analysis as port

CELLS = list(all_cells())


def test_there_are_35_cells():
    assert len(CELLS) == 35


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert port._attention_layer_counts(cfg) == ref._attention_layer_counts(rcfg)
    assert port.model_flops_for(cfg, SHAPES[shape]) == \
        ref.model_flops_for(rcfg, REF_SHAPES[shape])


#: (kind, payload bytes, group size) and the HLO line the reference parses
#: for it (its result shape is the payload)
RECORDS = [
    ("all-reduce", 2 * 4096 * 2048, 16,
     "%ar.1 = bf16[4096,2048]{1,0} all-reduce(bf16[4096,2048]{1,0} %x), "
     "replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, to_apply=%add"),
    ("all-gather", 4 * 16 * 1024, 4,
     "%ag.2 = f32[16,1024]{1,0} all-gather(f32[4,1024]{1,0} %y), "
     "replica_groups={{0,1,2,3}}, dimensions={0}"),
    ("reduce-scatter", 2 * 128 * 64, 8,
     "%rs.3 = bf16[128,64]{1,0} reduce-scatter(bf16[1024,64]{1,0} %z), "
     "replica_groups=[32,8]<=[256], dimensions={0}, to_apply=%add"),
    ("all-to-all", 4 * 8 * 8, 2,
     "%a2a.4 = f32[8,8]{1,0} all-to-all(f32[8,8]{1,0} %w), replica_groups={{0,1}}"),
    ("collective-permute", 2 * 512, 2,
     "%cp.5 = bf16[512]{0} collective-permute(bf16[512]{0} %v), "
     "source_target_pairs={{0,1},{1,0}}"),
    ("all-reduce", 4 * 1000, 2,
     "%ar.6 = f32[1000]{0} all-reduce(f32[1000]{0} %u), replica_groups={{0,1}}, "
     "to_apply=%add"),
]


def test_collective_bytes_equal_the_reference_on_hlo():
    records = [(k, b, n) for k, b, n, _ in RECORDS]
    hlo = "\n".join(line for *_, line in RECORDS)
    assert port.collective_bytes(records) == ref.collective_bytes_from_hlo(hlo)
    for rec in RECORDS:  # one at a time too
        assert port.collective_bytes([rec[:3]]) == ref.collective_bytes_from_hlo(rec[3])


def test_report_properties_equal_the_reference():
    fields = dict(arch="olmo_1b", shape="train_4k", mesh="single", chips=256,
                  hlo_flops_total=6.7e16, hlo_bytes_total=5.4e15,
                  collective_bytes_per_chip=3.1e11,
                  collective_breakdown={"all-gather": 2.4e11}, model_flops=7.4e15,
                  compute_s=0.26, memory_s=6.3, collective_s=6.1)
    assert port.RooflineReport(**fields).to_json() == ref.RooflineReport(**fields).to_json()
    zero = dict(fields, hlo_flops_total=0.0, compute_s=0.0, memory_s=0.0, collective_s=0.0)
    assert port.RooflineReport(**zero).to_json() == ref.RooflineReport(**zero).to_json()


def test_roofline_terms_equal_the_reference_at_the_same_peaks():
    records = [(k, b, n) for k, b, n, _ in RECORDS]
    hlo = "\n".join(line for *_, line in RECORDS)
    cost = {"flops": 2.5e14, "bytes accessed": 2.1e13}
    peaks = dict(peak_flops=mesh.PEAK_FLOPS_BF16, hbm_bw=mesh.HBM_BW, link_bw=mesh.LINK_BW)
    kw = dict(arch="olmo_1b", shape="train_4k", mesh_name="single", chips=256,
              cost=cost, model_flops=7.4e15)
    got = port.roofline_terms(records=records, **kw)
    want = ref.roofline_terms(hlo_text=hlo, **kw, **peaks)
    assert got.to_json() == want.to_json()


def test_h100_peaks():
    """The NVIDIA H100 SXM5 datasheet's figures, and the production meshes'
    link: a 16-wide axis of 8-GPU nodes crosses the network."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.CUDA_CORE_FLOPS_F32) == \
        (989e12, 3.35e12, 67e12)
    assert (mesh.NVLINK_BW, mesh.NET_BW, mesh.LINK_BW) == (450e9, 50e9, 50e9)
    report = port.roofline_terms(arch="a", shape="s", mesh_name="m", chips=1,
                                 cost={"flops": 989e12, "bytes accessed": 3.35e12},
                                 records=[("all-gather", 100e9, 2)], model_flops=1.0)
    assert (report.compute_s, report.memory_s, report.collective_s) == (1.0, 1.0, 1.0)
