"""The work of the FAST + NMS-L stage of one launch (every pyramid level of
every image of a frame), counted from the shapes so that no correct kernel
can need less:

- operations: the segment test of every pixel inside each level's ROI
  (20 px from the border), 16 ring pixels each compared above and below
  the centre's thresholds, 32 operations a pixel; the score and the
  non-maximum suppression of corners are left out (they depend on the
  data, so counting none keeps the count a floor);
- bytes: each level's pixels read once, and one (score, position) of 8
  bytes per tile written for the per-tile selection that reads them."""

KERNEL = "fast_nms_kernel"
BORDER = 20


def work(geom, n_images: int, valid_slots: float):
    roi = sum(max(h - 2 * BORDER, 0) * max(w - 2 * BORDER, 0)
              for h, w in zip(geom.heights, geom.widths))
    pixels = sum(h * w for h, w in zip(geom.heights, geom.widths))
    ops = 32 * roi * n_images
    nbytes = (pixels + 8 * geom.total_slots) * n_images
    return float(ops), float(nbytes)
