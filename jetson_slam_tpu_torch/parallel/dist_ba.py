"""Distributed bundle adjustment: the landmark-sharded Schur complement over
``torch.distributed``.

Port of ``jetson_slam_tpu/parallel/dist_ba.py``.  Landmarks and their edges
are split over the ranks of a process group; each rank reduces its own
landmark blocks, and only the reduced camera system (C x C x 6 x 6 plus its
right-hand side) and the LM costs are summed over the group.  Cameras are
replicated; the landmark back-substitution stays on each shard.  The LM is
the one body of ``core/local_ba.local_ba``, given an ``allreduce``: two
collectives per LM iteration (the packed system with f0 and the stop flag,
then f1), where the JAX body makes five, and one per solve before the LM
(whether any shard has a depth edge, which sets the damping).

Sharding contract (``partition_problem``, on the host):
- points go to ``n_shards`` contiguous blocks;
- every edge lives on its point's shard, so Hpp, Hpp^-1 and dxp need no
  communication;
- camera indices are global and replicated.

Every rank passes the same global problem to ``DistBA.solve``.  Before the
LM the ranks all-reduce a header of the problem's sizes and a digest of its
arrays, so ranks that hold different problems raise, each of them, instead
of waiting in a collective of another shape.  Backends: NCCL carries CUDA
tensors, gloo CPU tensors; a gloo group may carry CUDA tensors too (two
ranks sharing one card), and gloo's ``all_gather`` takes CPU tensors only,
so ``fetch_global`` copies to the host for that one call.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..core.local_ba import local_ba
from ..device import resolve_device


def partition_problem(n_shards, pts, e_cam, e_pt, obs, is_stereo, inv_sigma2,
                      e_valid):
    """Group the edges by point and pad each shard to the same size.

    Returns arrays shaped (n_shards * per_shard, ...), with point indices
    local to their shard and each point's edge list holding local edge
    indices, then ``per_pts``, ``per_e`` and ``e_perm``, the position of
    each original edge in the sharded layout: the JAX partitioner's output,
    array for array, from one stable sort of the edges by shard and one by
    point in place of its loop over edges."""
    pts = np.asarray(pts)
    e_cam, e_pt = np.asarray(e_cam), np.asarray(e_pt).astype(np.int64)
    P_total = pts.shape[0]
    per_pts = -(-P_total // n_shards)
    P_pad = per_pts * n_shards
    pts_p = np.zeros((P_pad, 3), pts.dtype)
    pts_p[:P_total] = pts

    E = len(e_cam)
    shard_of_edge = e_pt // per_pts
    counts = np.bincount(shard_of_edge, minlength=n_shards)
    per_e = int(counts.max()) if E else 1
    E_pad = per_e * n_shards
    # each edge's rank among its shard's edges, in edge order
    order = np.argsort(shard_of_edge, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    e_perm = np.zeros(E, np.int64)
    e_perm[order] = (shard_of_edge[order] * per_e
                     + np.arange(E) - starts[shard_of_edge[order]])

    def scatter(a, fill, dtype):
        out = np.full((E_pad,) + np.shape(a)[1:], fill, dtype)
        out[e_perm] = a
        return out

    e_cam_p = scatter(e_cam, 0, np.int32)
    e_ptl_p = scatter(e_pt % per_pts, 0, np.int32)
    obs_p = scatter(np.asarray(obs), 0, np.float32)
    stereo_p = scatter(np.asarray(is_stereo), False, bool)
    inv_s2_p = scatter(np.asarray(inv_sigma2), 1, np.float32)
    valid_p = scatter(np.asarray(e_valid), False, bool)

    # each point's local edge indices, in edge order
    deg = np.bincount(e_pt, minlength=P_total)
    max_deg = int(deg.max()) if E else 1
    pt_edges = np.full((P_pad, max_deg), -1, np.int32)
    by_pt = np.argsort(e_pt, kind="stable")
    pt_starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    p_sorted = e_pt[by_pt]
    pt_edges[p_sorted, np.arange(E) - pt_starts[p_sorted]] = e_perm[by_pt] % per_e
    return (pts_p, e_cam_p, e_ptl_p, obs_p, stereo_p, inv_s2_p, valid_p,
            pt_edges, per_pts, per_e, e_perm)


def _gloo_only(group) -> bool:
    return dist.get_backend(group) == "gloo"


def fetch_global(group, x):
    """Every rank's ``x`` concatenated on a new leading axis, on every rank:
    one ``all_gather``.  gloo gathers CPU tensors only, so on a gloo group
    a CUDA tensor is gathered through the host and comes back there."""
    src = x.contiguous()
    if src.is_cuda and _gloo_only(group):
        src = src.cpu()   # gloo's all_gather refuses CUDA tensors
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out)


def problem_digest(*arrays) -> list[int]:
    """A CRC-32 of each array's bytes: equal on two ranks only when the
    arrays are equal bit for bit."""
    return [zlib.crc32(np.ascontiguousarray(np.asarray(a)).tobytes()) for a in arrays]


class DistBA:
    """The process-group drop-in for ``core.local_ba.local_ba``.

    ``solve`` takes the same global problem arrays on every rank of
    ``group``, partitions them alike, keeps its own shard on ``device``,
    runs the sharded LM and returns (cam_R', cam_t', pts', outlier) as
    numpy arrays in the original point and edge order, on every rank.
    ``device`` is the card unless the caller asks for the CPU (a gloo
    group carries either).  ``stats`` holds the last solve's collectives:
    those of the LM, its iterations and those around it (the header check
    and the gather)."""

    def __init__(self, group=None, its1: int = 5, its2: int = 10, device="cuda"):
        self.group = group if group is not None else dist.group.WORLD
        self.n_shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.its1, self.its2 = its1, its2
        self.device = resolve_device(device)
        self.stats: dict = {}

    def _check_header(self, sizes, digest):
        """All-reduce the problem's sizes and digest with MAX, beside their
        negations: a rank whose header differs from another's sees max !=
        -max(-x) and raises, as every other rank does."""
        h = torch.tensor(list(sizes) + list(digest), dtype=torch.int64, device=self.device)
        both = torch.cat([h, -h])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        hi, lo = both[:len(h)], -both[len(h):]
        if not torch.equal(hi, lo):
            raise ValueError(
                f"DistBA: the {self.n_shards} ranks hold different problems "
                f"(rank {self.rank}: sizes C, P, E, D = {list(sizes)}; the group's "
                f"largest {hi[:4].tolist()}, smallest {lo[:4].tolist()})")

    def solve(self, cam_R, cam_t, cam_fixed, pts, e_cam, e_pt, obs, is_stereo,
              inv_sigma2, e_valid, fx, fy, cx, cy, bf, its1=None, its2=None,
              stop=None):
        """The sharded solve.  ``stop`` is ``local_ba``'s: a True on any rank
        ends the solve on every rank at the same iteration.  Edges with
        e_valid False weigh nothing in ``local_ba``; they are left out of
        the partition and their outlier flag is False, as there."""
        arrays = [np.asarray(a) for a in (cam_R, cam_t, cam_fixed, pts, e_cam, e_pt,
                                          obs, is_stereo, inv_sigma2, e_valid)]
        cam_R, cam_t, cam_fixed, pts, e_cam, e_pt, obs, is_stereo, inv_sigma2, e_valid = arrays
        E = len(e_cam)
        keep = np.flatnonzero(e_valid.astype(bool))
        (pts_p, e_cam_p, e_ptl_p, obs_p, stereo_p, inv_s2_p, valid_p, pt_edges,
         per_pts, per_e, e_perm) = partition_problem(
            self.n_shards, pts, e_cam[keep], e_pt[keep], obs[keep], is_stereo[keep],
            inv_sigma2[keep], e_valid[keep])
        cams = np.asarray([fx, fy, cx, cy, bf], np.float64)
        self._check_header((cam_R.shape[0], pts.shape[0], E, pt_edges.shape[1]),
                           problem_digest(*arrays, cams))

        r = self.rank
        sp, se = slice(r * per_pts, (r + 1) * per_pts), slice(r * per_e, (r + 1) * per_e)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        calls = {"packed": 0, "scalar": 0}

        def allreduce(x):
            calls["packed" if x.numel() > 1 else "scalar"] += 1
            dist.all_reduce(x, group=self.group)
            return x

        R2, t2, p2, outlier = local_ba(
            t(cam_R), t(cam_t), t(cam_fixed), t(pts_p[sp]), t(e_cam_p[se]),
            t(e_ptl_p[se]), t(obs_p[se]), t(stereo_p[se]), t(inv_s2_p[se]),
            t(valid_p[se]), t(pt_edges[sp]), fx, fy, cx, cy, bf,
            its1=self.its1 if its1 is None else its1,
            its2=self.its2 if its2 is None else its2, stop=stop, allreduce=allreduce)
        # the shards' points and outlier flags in one gather
        n_p = per_pts * 3
        packed = torch.cat([p2.reshape(-1), outlier.to(p2.dtype)])
        every = fetch_global(self.group, packed).cpu().numpy()
        pts_all = every[:, :n_p].reshape(-1, 3)[:pts.shape[0]]
        outlier_all = np.zeros(E, bool)
        outlier_all[keep] = every[:, n_p:].reshape(-1)[e_perm] > 0.5
        # local_ba's first collective, the depth flag, is once per solve
        self.stats = dict(lm_collectives=calls["packed"] + calls["scalar"] - 1,
                          lm_iterations=calls["packed"], other_collectives=3)
        return R2.cpu().numpy(), t2.cpu().numpy(), pts_all, outlier_all
