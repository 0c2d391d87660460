"""The output check that decides ``correct``.

During the run the harness keeps, for a sample of the fused frames drawn
from the seed as they come, what the timed path produced (the frame's
keypoints, descriptors and depths, the matches and the two poses of the
fused step) with the inputs the step started from (the predicted pose,
the last frame's slots and points, the local-map candidates), and for
every keyframe mapped the points triangulated with the two keyframes'
poses.  After the window the plain reference (``reference/``) recomputes
them from the images the benchmark made:

- front end: every slot's keypoint (``kp_gap_px``: the widest gap in
  pixels; a slot valid on one side only, or at another level, counts as
  the image's width), its descriptor (``desc_bits``: the share of bits
  that differ) and its stereo or RGB-D depth (``depth_gap``: the widest
  relative gap; a depth on one side only counts as 1);
- tracking, stage by stage from the state the step started from (the
  program's: the last frame's slots and points, the local-map candidates):
  the reference's motion-model search from the predicted pose and its
  pose LM, then its frustum check and local-map search from the program's
  stage-1 pose and matches and its LM.  ``match_diff``: the share of the
  current slots associated on either side whose association differs;
  ``pose_gap_m``: the widest camera-centre gap (m) of a stage where no
  observation lies within rounding of its chi2 gate (``GATE_MARGIN``);
- mapping: each new point of a sampled keyframe triangulated again from
  the two keyframes' poses and the reference's keypoints (``tri_gap``:
  the widest gap over the point's distance from the first camera).

A mono configuration (``"sensor": "mono"``) adds the two-view initializer,
which builds the whole first map (``MONO_NAMES``, ``MONO_COUNTS``).  Its
accepted call is held against ``reference/initializer.py``: both frames'
front ends as above, the all-pairs match to the reference frame (in
``match_diff``), then from the program's matches and minimal samples, on
the reference's keypoints, the hypotheses' scores, the choice of H or F,
the refit, the decomposition and the triangulation, each stage from the
program's decisions before it (``init_gap``: the larger of the initial
pose's camera-centre gap over the centre's distance and the widest gap of
a first point over its distance from the first camera, both read from the
map as the tracker built it).  A decision that the reference takes
otherwise, where the deciding quantity lies farther than ``INIT_MARGIN``
from its threshold (the best hypotheses, H or F, an inlier, a good point),
makes ``init_gap`` inf.  A mono map's unit is the initializer's: the
median scene depth of the first two views is 1, so ``pose_gap_m`` and
``tri_gap`` read in that unit there.  A mono slot has no depth: its
``depth`` and ``u_right`` are -1, and ``depth_gap`` reads 0 with nothing
to compare.

The control (``control=True``) puts the reference computed in bfloat16 in
the program's place: the configuration states float32.  A run is correct
only where every number is within its limit and it checked something of
each kind (``COUNTS``).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import initializer as ref_init
from .reference import pose as ref_pose
from .reference import search as ref_search
from .reference.frontend import Frontend
from .reference.synthetic import undistort_points
from .reference.triangulate import triangulate

NAMES = ("kp_gap_px", "desc_bits", "depth_gap", "match_diff", "pose_gap_m", "tri_gap")
# what a run has to have checked besides
COUNTS = ("frames_checked", "matches_checked", "stages_checked", "points_checked")
MONO_NAMES = NAMES + ("init_gap",)
MONO_COUNTS = COUNTS + ("inits_checked",)
# a pose stage is compared only where no observation's chi2 lies within
# this share of its gate at any of the LM's four classifications: there a
# float32 rounding of the pose moves the observation across the gate and
# the next round solves over another set
GATE_MARGIN = 2e-3
# an initializer decision that the reference takes otherwise counts only
# where its deciding quantity lies farther than this share from the
# threshold (the best hypothesis: its score below the best score by this
# share); within it the reference follows the program
INIT_MARGIN = 2e-3


def numbers_of(sensor: str):
    """The numbers compared with a limit and the counts that have to be
    above 0, for a configuration's sensor."""
    return (MONO_NAMES, MONO_COUNTS) if sensor == "mono" else (NAMES, COUNTS)


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float64)).to(torch.bfloat16).to(
        torch.float64).numpy()


class Judge:
    def __init__(self, config: dict, device):
        s = self.s = config["settings"]
        self.sensor = config["sensor"]
        args = (s["Camera.height"], s["Camera.width"], s["ORBextractor.nLevels"],
                s["ORBextractor.scaleFactor"], s["ORBextractor.FAST_N_MIN"],
                s["ORBextractor.FAST_N_MAX"], s["ORBextractor.th_FAST_MAX"],
                s["ORBextractor.tile_h"], s["ORBextractor.tile_w"])
        self.fe = Frontend(*args, device=device)
        self.fe16 = Frontend(*args, device=device, fdt=torch.bfloat16)
        self.cache = {}
        g = self.fe.g
        self.inv_s2 = (1.0 / np.asarray(g.scales, np.float64) ** 2)

    def lens(self):
        s = self.s
        return (s["Camera.fx"], s["Camera.fy"], s["Camera.cx"], s["Camera.cy"],
                s.get("Camera.k1", 0.0), s.get("Camera.k2", 0.0), s.get("Camera.p1", 0.0),
                s.get("Camera.p2", 0.0), s.get("Camera.k3", 0.0))

    def frontend(self, frames, i: int, low: bool = False):
        """The reference's slots of image i: dict of numpy arrays valid, xs,
        ys, octave, desc, depth, u_right and the undistorted kp_xy."""
        key = (i, low)
        if key in self.cache:
            return self.cache[key]
        fe = self.fe16 if low else self.fe
        s = self.s
        if self.sensor == "stereo":
            left, u_r, depth = fe.frame_step(frames.lefts[i], frames.rights[i],
                                             s["Camera.bf"], s["Camera.bf"] / s["Camera.fx"])
        elif self.sensor in ("rgbd", "mono"):
            left = fe.extract(frames.lefts[i])
        else:
            raise ValueError(f"unknown sensor {self.sensor!r}")
        out = {k: v.cpu().numpy() for k, v in left.items()}
        xy = np.stack([out["xs"], out["ys"]], 1).astype(np.float64)
        out["kp_xy"] = undistort_points(xy, *self.lens())
        if self.sensor == "stereo":
            out["depth"], out["u_right"] = depth.cpu().numpy(), u_r.cpu().numpy()
        elif self.sensor == "mono":
            out["depth"] = np.full(len(out["valid"]), -1.0)
            out["u_right"] = out["depth"].copy()
        else:
            img = np.asarray(frames.depths[i], np.float32)
            H, W = img.shape
            xi = np.clip(out["xs"].astype(np.int64), 0, W - 1)
            yi = np.clip(out["ys"].astype(np.int64), 0, H - 1)
            z = img[yi, xi]
            pos = (z > 0) & out["valid"]
            out["depth"] = np.where(pos, z, -1.0)
            ur = out["kp_xy"][:, 0] - s["Camera.bf"] / np.maximum(z, 1e-6)
            out["u_right"] = np.where(pos, _bf16(ur) if low else ur, -1.0)
        if low:
            out["kp_xy"] = _bf16(out["kp_xy"])
        self.cache[key] = out
        return out

    # ------------------------------------------------------------ numbers
    def frontend_numbers(self, prog: dict, ref: dict):
        v_p, v_r = prog["valid"], ref["valid"]
        W = float(self.s["Camera.width"])
        both = v_p & v_r
        mism = (v_p != v_r) | (both & (prog["octave"] != ref["octave"]))
        gap = 0.0
        if both.any():
            gap = float(max(np.abs(prog["xs"][both] - ref["xs"][both]).max(),
                            np.abs(prog["ys"][both] - ref["ys"][both]).max()))
        if mism.any():
            gap = W
        bits = np.unpackbits(np.bitwise_xor(prog["desc"][both], ref["desc"][both]), axis=1)
        n_bits = int(bits.sum()), int(bits.size)
        dp, dr = prog["depth"][both], ref["depth"][both]
        one_side = (dp > 0) != (dr > 0)
        dgap = 1.0 if one_side.any() else 0.0
        has = (dp > 0) & (dr > 0)
        if has.any():
            dgap = max(dgap, float((np.abs(dp[has] - dr[has]) / dr[has]).max()))
        return gap, n_bits, dgap

    def _cam(self, dtype):
        s, dev = self.s, self.fe.dev
        T = lambda v: torch.tensor(float(v), dtype=dtype, device=dev)  # noqa: E731
        return tuple(T(v) for v in (s["Camera.fx"], s["Camera.fy"], s["Camera.cx"],
                                    s["Camera.cy"], s["Camera.bf"]))

    def _lm(self, obs, R0, t0, pts, valid, dtype):
        s = self.s
        cam = (s["Camera.fx"], s["Camera.fy"], s["Camera.cx"], s["Camera.cy"], s["Camera.bf"])
        return ref_pose.pose_optimization(
            np.asarray(R0, np.float64), np.asarray(t0, np.float64), pts,
            obs["kp_xy"], obs["u_right"].astype(np.float64),
            self.inv_s2[obs["octave"]], valid, *cam, dtype=dtype)

    def _stages(self, rec, obs, dtype, prog=None):
        """The two stages of the fused step in the reference, on ``obs``
        (a front end's slots) in ``dtype``.  Stage 1: the motion-model
        search from the step's predicted pose over the step's last-frame
        state, then the pose LM on its matches.  Stage 2: the frustum check
        and local-map search over the step's candidates from the stage-1
        pose and matches of ``prog`` (the program's, or this chain's own
        where None), then the LM.  Returns dict m, R1, t1, margin1, sel,
        R2, t2, margin2 (numpy)."""
        dev = self.fe.dev
        g = self.fe.g
        cam5 = self._cam(dtype)
        lim = tuple(torch.tensor(float(v), dtype=dtype, device=dev) for v in rec["lims"])
        cam = cam5 + lim
        T = lambda a, dt=dtype: torch.as_tensor(np.asarray(a)).to(dev, dt)  # noqa: E731
        scales = T(np.asarray(g.scales, np.float64))
        cur = {"kp_xy": T(obs["kp_xy"]), "octave": T(obs["octave"], torch.int64),
               "angle": T(obs["angle"], torch.float64), "desc": T(obs["desc"], torch.uint8),
               "valid": T(obs["valid"], torch.bool), "u_right": T(obs["u_right"])}
        last = {"pw": T(rec["last_pw"]), "has_pt": T(rec["last_has_pt"], torch.bool),
                "octave": T(rec["last_octave"], torch.int64),
                "angle": T(rec["last_angle"], torch.float64),
                "desc": T(rec["last_desc"], torch.uint8)}
        pred = np.asarray(rec["pred"], np.float64)
        m = ref_search.motion_model_matches(
            T(pred[:3, :3]), T(pred[:3, 3]), last, cur, T(rec["th_mm"]), scales,
            g.n_levels, cam, rec["forward"], rec["backward"]).cpu().numpy()
        out = {"m": m}
        pw = np.asarray(rec["last_pw"], np.float64)
        has_m = m >= 0
        R1, t1, _, out["margin1"] = self._lm(obs, pred[:3, :3], pred[:3, 3],
                                               pw[np.where(has_m, m, 0)], has_m, dtype)
        out["R1"], out["t1"] = R1, t1
        src = out if prog is None else prog
        m_in, R1_in, t1_in = src["m"], src["R1"], src["t1"]
        has_m = m_in >= 0
        midx = np.where(has_m, m_in, 0)
        exist_real = has_m & np.asarray(rec["last_real"], bool)[midx]
        pid_cur = np.where(exist_real, np.asarray(rec["last_pid"])[midx], -1)
        cpid = np.asarray(rec["cand_pid"])
        in_frame = np.isin(cpid, pid_cur[pid_cur >= 0]) & (cpid >= 0)
        cand = {"pos": T(rec["cand_pos"]), "normal": T(rec["cand_normal"]),
                "maxd": T(rec["cand_maxd"]), "mind": T(rec["cand_mind"]),
                "desc": T(rec["cand_desc"], torch.uint8),
                "alive": T(np.asarray(rec["cand_alive"], bool) & ~in_frame, torch.bool)}
        sel = ref_search.local_map_matches(
            T(np.asarray(R1_in, np.float64)), T(np.asarray(t1_in, np.float64)), cand,
            T(~exist_real, torch.bool), cur, T(rec["th_lm"]), scales, g.n_levels,
            T(rec["log_scale"]), cam).cpu().numpy()
        has_sel = sel >= 0
        cpos = np.asarray(rec["cand_pos"], np.float64)
        pts2 = np.where(has_sel[:, None], cpos[np.where(has_sel, sel, 0)],
                        np.where(exist_real[:, None], pw[midx], 0.0))
        R2, t2, _, out["margin2"] = self._lm(obs, R1_in, t1_in, pts2,
                                               exist_real | has_sel, dtype)
        out.update(sel=sel, R2=R2, t2=t2)
        return out

    def track_numbers(self, rec: dict, ref: dict, low: dict | None = None):
        """The step's matches and poses against the reference's, stage by
        stage (stage 2 from the program's own stage-1 pose and matches):
        the camera-centre gaps (m) of the stages where no observation lies
        within rounding of its chi2 gate, and the slots whose association
        differs with the slots associated on either side.  ``low``: the
        control's front end; the reference's chain in bfloat16 stands in
        the program's place."""
        prog = rec
        if low is not None:
            prog = self._stages(rec, low, torch.bfloat16)
        r = self._stages(rec, ref, torch.float64, prog=prog)
        gaps = []
        for R_p, t_p, R_r, t_r, margin in ((prog["R1"], prog["t1"], r["R1"], r["t1"],
                                            r["margin1"]),
                                           (prog["R2"], prog["t2"], r["R2"], r["t2"],
                                            r["margin2"])):
            if margin < GATE_MARGIN:
                continue    # an observation within rounding of its gate
            c_p = -np.asarray(R_p, np.float64).T @ np.asarray(t_p, np.float64)
            gaps.append(float(np.linalg.norm(c_p + R_r.T @ t_r)))
        n_diff = n_assoc = 0
        for a, b in ((np.asarray(prog["m"]), r["m"]), (np.asarray(prog["sel"]), r["sel"])):
            either = (a >= 0) | (b >= 0)
            n_diff += int((either & (a != b)).sum())
            n_assoc += int(either.sum())
        return gaps, n_diff, n_assoc

    def tri_numbers(self, frames, kf: dict, low: bool):
        """The widest relative gap of a keyframe's new points."""
        s = self.s
        fx, fy, cx, cy = s["Camera.fx"], s["Camera.fy"], s["Camera.cx"], s["Camera.cy"]
        a = self.frontend(frames, kf["img1"])
        b = self.frontend(frames, kf["img2"])
        rnd = _bf16 if low else None
        gap, n = 0.0, 0
        for sl1, sl2, p_prog in zip(kf["s1"], kf["s2"], kf["points"]):
            if not (a["valid"][sl1] and b["valid"][sl2]):
                return float("inf"), 1
            args = (kf["pose1"][:3, :3], kf["pose1"][:3, 3], kf["pose2"][:3, :3],
                    kf["pose2"][:3, 3], a["kp_xy"][sl1], b["kp_xy"][sl2],
                    float(a["depth"][sl1]), float(b["depth"][sl2]), fx, fy, cx, cy,
                    s["Camera.bf"])
            mono = self.sensor == "mono"
            p_ref, decided = triangulate(*args, mono=mono)
            if not decided:
                continue
            if low:
                p_prog, _ = triangulate(*args, round_to=rnd, mono=mono)
            c1 = -kf["pose1"][:3, :3].T.astype(np.float64) @ kf["pose1"][:3, 3]
            dist = max(float(np.linalg.norm(p_ref - c1)), 1e-9)
            gap = max(gap, float(np.linalg.norm(np.asarray(p_prog, np.float64) - p_ref)) / dist)
            n += 1
        return gap, n

    def brute_force(self, a: dict, b: dict):
        """The mono initialization's all-pairs match of front end ``a``'s
        slots to ``b``'s in the reference: per slot of ``a`` the slot of
        ``b``, or -1."""
        dev = self.fe.dev
        T = lambda x, dt: torch.as_tensor(np.asarray(x)).to(dev, dt)  # noqa: E731
        return ref_search.brute_force_matches(
            T(a["desc"], torch.uint8), T(a["valid"], torch.bool), T(a["angle"], torch.float64),
            T(b["desc"], torch.uint8), T(b["valid"], torch.bool),
            T(b["angle"], torch.float64)).cpu().numpy()

    @staticmethod
    def match_numbers(prog, ref):
        """The slots whose match differs, and those matched on either side."""
        prog = np.asarray(prog)
        either = (prog >= 0) | (ref >= 0)
        return int((either & (prog != ref)).sum()), int(either.sum())

    def _program_init(self, rec: dict, s2):
        """The program's decisions and first map from its kept initializer
        call, or None where the call is not the one the map came from."""
        scores = rec["scores"]
        batched = {kind: sc for kind, sc, _ in scores if np.ndim(sc) == 1}
        singles = [(kind, ok) for kind, sc, ok in scores if np.ndim(sc) == 0]
        if set(batched) != {"h", "f"} or len(singles) != 2 or singles[0][0] != singles[1][0]:
            return None
        good = rec["out"][4]
        if len(good) != len(s2):
            return None
        pose = np.asarray(rec["pose2"], np.float64)
        at = dict(zip(rec["pt_slots"].tolist(), rec["pt_pos"]))
        pts = [at.get(int(sl)) for sl in s2[good]]
        if any(p is None for p in pts):
            return None
        return {"bh": int(np.argmax(batched["h"])), "bf": int(np.argmax(batched["f"])),
                "use_h": singles[0][0] == "h", "inl_pre": singles[0][1],
                "inl_post": singles[1][1], "good": np.asarray(good, bool),
                "R": pose[:3, :3], "t": pose[:3, 3], "points": np.asarray(pts).reshape(-1, 3)}

    def init_numbers(self, frames, rec: dict, low: bool):
        """``init_gap`` of one accepted initializer call: the reference's
        chain from the same matches and minimal samples, on the reference's
        keypoints, following the program's decisions (``low``: the
        reference's own chain in bfloat16 stands in the program's place,
        its map scaled as the tracker scales it)."""
        s = self.s
        cam = (s["Camera.fx"], s["Camera.fy"], s["Camera.cx"], s["Camera.cy"])
        a = self.frontend(frames, rec["fe1"]["img"])
        b = self.frontend(frames, rec["fe2"]["img"])
        match = np.asarray(rec["match"])
        s1 = np.flatnonzero(match >= 0)
        s2 = match[s1]
        valid, sample = np.asarray(rec["args"][2], bool), np.asarray(rec["sample"])
        if len(valid) != len(s1):
            return float("inf")
        if low:
            la = self.frontend(frames, rec["fe1"]["img"], low=True)
            lb = self.frontend(frames, rec["fe2"]["img"], low=True)
            prog = ref_init.initialize(la["kp_xy"][s1], lb["kp_xy"][s2], valid, sample, *cam,
                                       round_to=_bf16)
            good = prog["good"]
            med = np.median(prog["X"][good, 2]) if good.any() else 0.0
            if med <= 0:
                return float("inf")
            prog.update(t=prog["t"] / med, points=prog["X"][good] / med)
        else:
            prog = self._program_init(rec, s2)
            if prog is None:
                return float("inf")
        ref = ref_init.initialize(a["kp_xy"][s1], b["kp_xy"][s2], valid, sample, *cam,
                                  follow=prog)
        good = prog["good"]

        def short(sc, i):
            return (sc.max() - sc[i]) / max(abs(sc.max()), 1e-12)
        rh_clear = not abs(ref["rh"] - ref_init.RH_MIN) <= INIT_MARGIN
        differs = (short(ref["sh"], prog["bh"]) > INIT_MARGIN
                   or short(ref["sf"], prog["bf"]) > INIT_MARGIN
                   or (rh_clear and ref["use_h"] != prog["use_h"]))
        for key, m in (("inl_pre", "m_pre"), ("inl_post", "m_post"), ("good", "m_good")):
            differs |= bool(((np.asarray(prog[key]) != ref[key]) & (ref[m] > INIT_MARGIN)).any())
        med = np.median(ref["X"][good, 2]) if good.any() else 0.0
        if differs or med <= 0:
            return float("inf")
        c_ref = -ref["R"].T @ (ref["t"] / med)
        c_prog = -np.asarray(prog["R"], np.float64).T @ np.asarray(prog["t"], np.float64)
        gap = float(np.linalg.norm(c_prog - c_ref) / max(np.linalg.norm(c_ref), 1e-12))
        pts = ref["X"][good] / med
        d = np.linalg.norm(np.asarray(prog["points"], np.float64) - pts, axis=1)
        return max(gap, float((d / np.maximum(np.linalg.norm(pts, axis=1), 1e-12)).max()))

    def judge(self, frames, recs: list, kfs: list, inits: list = (),
              control: bool = False) -> dict:
        """The numbers over the sampled frames, keyframes and, for mono,
        the initializer's accepted calls."""
        names, _ = numbers_of(self.sensor)
        out = dict.fromkeys(names, 0.0)
        bits = [0, 0]
        assoc = [0, 0]
        n_stages = 0

        def front(fe_rec):
            ref = self.frontend(frames, fe_rec["img"])
            prog = self.frontend(frames, fe_rec["img"], low=True) if control else fe_rec
            gap, (nb, nt), dgap = self.frontend_numbers(prog, ref)
            out["kp_gap_px"] = max(out["kp_gap_px"], gap)
            out["depth_gap"] = max(out["depth_gap"], dgap)
            bits[0] += nb
            bits[1] += nt
            return ref, prog

        n_frames = len(recs)
        for rec in recs:
            ref, prog = front(rec)
            gaps, nd, na = self.track_numbers(rec, ref, prog if control else None)
            out["pose_gap_m"] = max([out["pose_gap_m"]] + gaps)
            n_stages += len(gaps)
            assoc[0] += nd
            assoc[1] += na
        for rec in inits:       # mono only
            ref1, prog1 = front(rec["fe1"])
            ref2, prog2 = front(rec["fe2"])
            match = self.brute_force(prog1, prog2) if control else rec["match"]
            nd, na = self.match_numbers(match, self.brute_force(ref1, ref2))
            assoc[0] += nd
            assoc[1] += na
            out["init_gap"] = max(out["init_gap"], self.init_numbers(frames, rec, control))
            n_frames += 2
        out["desc_bits"] = bits[0] / max(bits[1], 1)
        out["match_diff"] = assoc[0] / max(assoc[1], 1)
        n_pts = 0
        for kf in kfs:
            gap, n = self.tri_numbers(frames, kf, control)
            out["tri_gap"] = max(out["tri_gap"], gap)
            n_pts += n
        out["frames_checked"] = n_frames
        out["stages_checked"] = n_stages
        out["points_checked"] = n_pts
        out["matches_checked"] = assoc[1]
        if self.sensor == "mono":
            out["inits_checked"] = len(inits)
        return out
