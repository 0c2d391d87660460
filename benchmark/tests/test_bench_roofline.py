"""The roofline counts against counts worked by hand, at two shapes; they
read only the shapes and the valid slots, never a kernel's launch layout."""
import inspect

import pytest

from benchmark import harness
from benchmark.reference import tables

fast = harness.load_module("roofline", "fast_nms")
desc = harness.load_module("roofline", "orb_descriptor")


def test_fast_nms_one_level_100x60():
    g = tables.pyramid_geometry(60, 100, 1, 1.2, 30, 30)
    ops, nbytes = fast.work(g, 2, 0)
    # ROI (60 - 40) x (100 - 40) = 1200 px, 32 ops each, two images
    assert ops == 32 * 1200 * 2
    # 6000 px read, 2 x 4 tiles of 8 bytes written, per image
    assert nbytes == (6000 + 8 * 8) * 2


def test_fast_nms_two_levels_200x100():
    g = tables.pyramid_geometry(100, 200, 2, 2.0, 20, 20)
    assert (g.heights, g.widths) == ((100, 50), (200, 100))
    ops, nbytes = fast.work(g, 1, 0)
    assert ops == 32 * (60 * 160 + 10 * 60)
    # 50 tiles of 20 px at level 0, 50 of 10 px at level 1
    assert nbytes == 20000 + 5000 + 8 * 100


@pytest.mark.parametrize("valid", [1000, 4819])
def test_orb_descriptor_counts(valid):
    # the 31-px disc of ORB's umax: 31 + 2 * sum(2 umax[v] + 1, v = 1..15)
    assert desc.disc_pixels() == 749
    ops, nbytes = desc.work(None, 2, valid)
    assert ops == (4 * 749 + 3 + 6 * 512 + 14 * 512 + 256) * valid
    assert nbytes == 48 * valid


def test_counts_read_only_shapes():
    for mod in (fast, desc):
        assert list(inspect.signature(mod.work).parameters) == [
            "geom", "n_images", "valid_slots"]
    # the port's geometry and the reference's give the same count
    from jetson_slam_tpu_torch.ops import tables as port_tables
    a = fast.work(port_tables.pyramid_geometry(480, 752, 8, 1.2, 30, 30), 2, 0)
    b = fast.work(tables.pyramid_geometry(480, 752, 8, 1.2, 30, 30), 2, 0)
    assert a == b
