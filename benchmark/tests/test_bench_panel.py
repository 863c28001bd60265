"""The generator's copy: deterministic per seed, and the planes that the
program's ModelData takes."""

import torch

from benchmark import harness, panel
from benchmark.tests.helpers import CPU


def _conf(**kw):
    conf = harness.load_cell("hgdp650k.admix_k7").config
    return dict(conf, individuals=120, loci=700, **kw)


def test_same_seed_same_panel_other_seed_other_panel():
    a = panel.make_panel(_conf(), 2**31 + 3, CPU)
    b = panel.make_panel(_conf(), 2**31 + 3, CPU)
    c = panel.make_panel(_conf(), 2**31 + 4, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_planes_shapes_dtypes_and_counts():
    planes, miss = panel.make_panel(_conf(missing_rate=0.05), 9, CPU)
    assert planes.shape == (2, 120, 700) and miss.shape == (120, 700)
    assert planes.dtype == miss.dtype == torch.int8
    assert planes.is_contiguous()
    assert torch.equal(planes.sum(0) + miss, torch.full_like(miss, 2))
    assert set(miss.unique().tolist()) == {0, 2}
    assert abs(float((miss > 0).float().mean()) - 0.05) < 0.01


def test_no_missing_genotypes_when_the_rate_is_zero():
    _, miss = panel.make_panel(_conf(missing_rate=0.0), 1, CPU)
    assert not bool(miss.any())


def test_the_program_takes_the_planes_as_they_are():
    from multiclust_tpu_torch.model.common import model_data_from_planes

    planes, miss = panel.make_panel(_conf(), 3, CPU)
    md = model_data_from_planes(planes, miss)
    assert (md.I, md.L, md.M) == (120, 700, 2)
    assert md.x0.data_ptr() == planes[0].data_ptr()
