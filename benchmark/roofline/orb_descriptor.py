"""The work of the descriptor stage of one launch for its valid slots,
counted from the algorithm so that no correct kernel can need less:

- per valid slot: the intensity-centroid moments (a multiply and an add
  for each of two moments at each pixel of the 31-px disc), the angle's
  atan2, cos and sin (3), the rotation of the 512 pattern points (4
  multiplies and 2 adds each), the vertical pass of the 7-tap blur at
  each of the 512 samples (7 multiplies and 7 adds; the horizontal pass,
  which neighbouring samples can share, is left out) and the 256
  comparisons;
- bytes: the keypoint read (12 bytes) and the descriptor and angle
  written (36 bytes) per valid slot; the image windows, which overlap,
  are left out."""
from benchmark.reference import tables

KERNEL = "orb_descriptor_kernel"


def disc_pixels() -> int:
    umax = tables.umax_table()
    hp = tables.HALF_PATCH_SIZE
    return int(sum(2 * int(umax[abs(v)]) + 1 for v in range(-hp, hp + 1)))


def work(geom, n_images: int, valid_slots: float):
    per_slot = 4 * disc_pixels() + 3 + 6 * 512 + 14 * 512 + 256
    return float(per_slot * valid_slots), float(48 * valid_slots)
