"""Incremental structure-from-motion: the SfmMap pipeline.

Port of ``siftmetal_tpu/slam/sfm.py``: two-view bootstrap (essential
RANSAC + pose recovery + triangulation), keyframe registration by PnP
RANSAC against map landmarks, landmark growth by triangulation against
the previous keyframe, culling, loop-closure detection, local and global
Schur BA and pose-graph repair.

The map's bookkeeping is a padded SoA of numpy arrays on the host with
static budgets (cameras, landmarks, observations) and fill counters, as
in the JAX package. Matching, RANSAC, PnP, triangulation, projection, BA
and the pose graph run on the map's device (``SfmMap(k, config,
device)``: CUDA unless the caller asks for the CPU); the per-frame Python
orchestration moves their results to the host.

Frames enter as (xy [N, 2] row/col pixels, descriptors [N, 128] uint8,
valid [N]), i.e. what ``SIFT.extract`` produces (tensors or arrays).

Random draws take an explicit ``generator`` on the map's device; without
one each method seeds a fresh generator from the constant the JAX method
seeds its key with (the same seeds, not the same streams).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.ransac import find_fundamental
from ..geometry.twoview import essential_from_fundamental, recover_pose, triangulate
from ..match.matcher import match_bruteforce, match_guided
from .ba import BAProblem, bundle_adjust, residuals
from .camera import project, relative, rodrigues, so3_log
from .pnp import pnp_ransac, pnp_refine
from .pose_graph import PoseGraph
from .pose_graph import optimize_pose_graph as _optimize_pose_graph


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rot(w: np.ndarray) -> np.ndarray:
    """Rotation matrix of one axis-angle 3-vector, on the host."""
    return rodrigues(torch.from_numpy(np.asarray(w, np.float32))).numpy()


def _parallax_ok(
    pts3: np.ndarray, cam_a: np.ndarray, cam_b: np.ndarray, min_angle: float
) -> np.ndarray:
    """True where the triangulation angle at each point — between the
    bearing rays from the two camera centers — exceeds ``min_angle``
    (radians). Near-parallel rays (points near the epipole) make depth
    unobservable; see SfmConfig.triangulation_min_parallax."""
    centers = _camera_centers(np.stack([cam_a, cam_b]).astype(np.float32))
    r1 = (pts3 - centers[0]).astype(np.float64)
    r2 = (pts3 - centers[1]).astype(np.float64)
    # atan2(|r1 x r2|, r1.r2): stable at SMALL angles, where the cosine
    # form saturates in float32.
    cross = np.cross(r1, r2)
    ang = np.arctan2(np.linalg.norm(cross, axis=1), (r1 * r2).sum(axis=1))
    return ang > min_angle


def _camera_centers(cams: np.ndarray) -> np.ndarray:
    """Camera centers -R^T t for [N, 6] (rvec, t) poses, vectorized in
    numpy (Rodrigues rotation of t by -theta about the unit axis)."""
    rv = cams[:, :3].astype(np.float64)
    t = cams[:, 3:].astype(np.float64)
    th = np.linalg.norm(rv, axis=1, keepdims=True)
    w = np.where(th > 1e-12, rv / np.maximum(th, 1e-12), 0.0)
    s, co = np.sin(th), np.cos(th)
    rt = co * t - s * np.cross(w, t) + (1.0 - co) * ((w * t).sum(1, keepdims=True) * w)
    return -rt


def _rotations(cams: np.ndarray) -> np.ndarray:
    """[N, 3, 3] rotation matrices for [N, 6] (rvec, t) poses,
    vectorized Rodrigues in numpy."""
    rv = cams[:, :3].astype(np.float64)
    th = np.linalg.norm(rv, axis=1)
    w = np.where(th[:, None] > 1e-12, rv / np.maximum(th[:, None], 1e-12), 0.0)
    k = np.zeros((len(cams), 3, 3))
    k[:, 0, 1], k[:, 0, 2] = -w[:, 2], w[:, 1]
    k[:, 1, 0], k[:, 1, 2] = w[:, 2], -w[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -w[:, 1], w[:, 0]
    eye = np.eye(3)[None]
    s, co = np.sin(th)[:, None, None], np.cos(th)[:, None, None]
    return eye + s * k + (1.0 - co) * (k @ k)


def _bucket(n: int, cap: int, floor: int = 8) -> int:
    """Next power of two >= max(n, floor), capped at ``cap``.

    Map steps (BA, pose graph, map matching) slice/pad their arrays to
    this FILL bucket rather than the full static budget: a 512-camera-
    budget map with 12 keyframes solves a [96, 96] system, not
    [3072, 3072]."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass(frozen=True)
class SfmConfig:
    """The JAX package's ``SfmConfig``, field for field; the measurements
    behind each default are recorded there."""

    max_cameras: int = 512
    max_landmarks: int = 65536
    max_observations: int = 262144
    new_landmarks_per_frame: int = 1024
    match_absolute_threshold: float = 1.176
    match_ratio_threshold: float = 0.7
    ransac_hypotheses: int = 512
    pnp_inlier_threshold: float = 4.0
    # Guided re-matching after PnP: unmatched keypoints may claim a map
    # landmark projecting within this pixel gate (0 disables); the gate
    # replaces the ratio test and the relaxed absolute threshold applies.
    guided_rematch_radius: float = 16.0
    guided_abs_threshold: float = 1.3
    # Image-motion bound (px) of the duplicate-aware PnP rescue: a
    # ratio-killed keypoint's candidate landmark must reproject within it
    # in the PREVIOUS keyframe's pose.
    rescue_reproj_radius: float = 24.0
    # Reprojection gate (px) for track merging in add_frame.
    track_merge_reproj_radius: float = 10.0
    # A triangulated "new" point matching an existing landmark within
    # track_merge_frac * depth becomes an observation of it (0 disables).
    track_merge_frac: float = 0.05
    # Loop-closure detection (detect_loop_closures).
    loop_min_gap: int = 10
    loop_min_matches: int = 40
    loop_min_inliers: int = 20
    # Only this many eligible keyframes nearest the current estimate are
    # matched (0 = all), one per loop_min_gap-wide temporal cluster.
    loop_max_candidates: int = 8
    # PnP conditioning gate: inlier pixels' std in both image axes.
    loop_min_uv_spread: float = 40.0
    # Minimum PnP inliers to commit a keyframe registration.
    min_pnp_inliers: int = 10
    triangulation_min_depth: float = 1e-3
    # Minimum parallax angle (radians) of a NEW landmark's two bearing
    # rays (initialize + add_frame); 0 disables.
    triangulation_min_parallax: float = 0.004
    # Culling: a landmark with fewer than cull_min_obs observations
    # cull_age keyframes after its creation is tombstoned (0 disables).
    cull_min_obs: int = 3
    cull_age: int = 8
    # Keyframe index at which init-generation landmarks are
    # re-triangulated from (frame 0, latest frame) with current poses.
    init_reanchor_at: int = 8
    # Reprojection-health culling: median live residual above
    # cull_reproj_mult * pnp_inlier_threshold tombstones (0 disables).
    cull_reproj_mult: float = 4.0
    # Delayed bootstrap (initialize_delayed): median parallax bar of the
    # trial two-view reconstruction, and the candidate frames searched.
    bootstrap_min_parallax: float = 0.02
    bootstrap_max_delay: int = 30
    ba_iterations: int = 6
    ba_huber_delta: float = 3.0


class SfmMap:
    """Host-side map container; its heavy steps run on ``device``."""

    def __init__(self, k: np.ndarray, config: Optional[SfmConfig] = None, device=None):
        c = config if config is not None else SfmConfig()
        self.config = c
        self.device = resolve_device(device)
        self._k = np.asarray(_np(k), dtype=np.float32)
        self.k = torch.tensor(self._k, device=self.device)
        self.cameras = np.zeros((c.max_cameras, 6), dtype=np.float32)
        self.n_cameras = 0
        self.landmarks = np.zeros((c.max_landmarks, 3), dtype=np.float32)
        self.lm_desc = np.zeros((c.max_landmarks, 128), dtype=np.uint8)
        self.n_landmarks = 0
        self.obs_cam = np.zeros(c.max_observations, dtype=np.int32)
        self.obs_lm = np.zeros(c.max_observations, dtype=np.int32)
        self.obs_uv = np.zeros((c.max_observations, 2), dtype=np.float32)
        self.n_obs = 0
        # Landmark lifecycle (cull_landmarks): alive tombstones, creation
        # keyframe, observation support count, per-observation liveness.
        self.lm_alive = np.ones(c.max_landmarks, dtype=bool)
        self.lm_created = np.zeros(c.max_landmarks, dtype=np.int32)
        self.lm_nobs = np.zeros(c.max_landmarks, dtype=np.int32)
        self.obs_alive = np.ones(c.max_observations, dtype=bool)
        self.n_culled = 0
        self.frames = []    # (xy, desc, valid) tensors per registered keyframe
        self.odometry = []  # rel pose i -> i+1 measured at registration

    # -- helpers ---------------------------------------------------------
    def _t(self, a, dtype=None) -> torch.Tensor:
        """An array (copied) or a tensor on the map's device; float64
        arrives as float32."""
        if torch.is_tensor(a):
            if dtype is None and a.dtype == torch.float64:
                dtype = torch.float32
            return a.to(device=self.device, dtype=dtype)
        arr = np.asarray(a)
        if dtype is None and arr.dtype == np.float64:
            dtype = torch.float32
        return torch.tensor(arr).to(device=self.device, dtype=dtype)

    def _frame(self, frame):
        xy, desc, valid = frame
        return (self._t(xy, torch.float32), self._t(desc, torch.uint8),
                self._t(valid, torch.bool))

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _project(self, cam: np.ndarray, pts: np.ndarray) -> np.ndarray:
        """Pixels of [N, 3] world points through one camera, on the device."""
        return _np(project(self._t(cam, torch.float32), self.k, self._t(pts, torch.float32)))

    def _relative(self, cam_i, cam_j) -> np.ndarray:
        return _np(relative(self._t(cam_i, torch.float32),
                            self._t(cam_j, torch.float32))).astype(np.float32)

    def _match(self, qd, td, qv, tv, ratio=None):
        c = self.config
        return match_bruteforce(
            qd, td, qv, tv,
            absolute_threshold=c.match_absolute_threshold,
            ratio_threshold=c.match_ratio_threshold if ratio is None else ratio,
        )

    def _add_observations(self, cam_idx, lm_idx, uv):
        n = len(lm_idx)
        if n == 0:
            return
        end = self.n_obs + n
        assert end <= self.config.max_observations, "observation overflow"
        self.obs_cam[self.n_obs:end] = cam_idx
        self.obs_lm[self.n_obs:end] = lm_idx
        self.obs_uv[self.n_obs:end] = uv
        np.add.at(self.lm_nobs, lm_idx, 1)
        self.n_obs = end

    def _add_landmarks(self, pts3, desc):
        n = len(pts3)
        end = self.n_landmarks + n
        assert end <= self.config.max_landmarks, "landmark overflow"
        idx = np.arange(self.n_landmarks, end, dtype=np.int32)
        self.landmarks[self.n_landmarks:end] = pts3
        self.lm_desc[self.n_landmarks:end] = desc
        self.lm_created[self.n_landmarks:end] = max(self.n_cameras - 1, 0)
        self.n_landmarks = end
        return idx

    def cull_landmarks(self) -> int:
        """Tombstone landmarks whose observation support never grew past
        their creation pair (see SfmConfig.cull_min_obs / cull_age), and
        those whose median live reprojection residual is unhealthy. Their
        observations are masked out of BA and reprojection stats;
        matching never offers them again. Returns the number retired."""
        c = self.config
        if c.cull_age <= 0 or self.n_landmarks == 0:
            return 0
        n = self.n_landmarks
        kill = (
            self.lm_alive[:n]
            & (self.lm_nobs[:n] < c.cull_min_obs)
            & (self.lm_created[:n] <= self.n_cameras - 1 - c.cull_age)
        )
        if c.cull_reproj_mult > 0 and self.n_obs > 0:
            # Reprojection health: median live residual per landmark
            # (vectorized numpy over all observations).
            no = self.n_obs
            oc = self.obs_cam[:no]
            ol = self.obs_lm[:no]
            alive_o = self.obs_alive[:no]
            rs = _rotations(self.cameras[: self.n_cameras])
            pts = self.landmarks[ol]
            pc = np.einsum("nij,nj->ni", rs[oc], pts) + self.cameras[oc, 3:]
            z = np.maximum(pc[:, 2], 1e-9)
            kmat = self._k
            u = kmat[0, 0] * pc[:, 0] / z + kmat[0, 2]
            v = kmat[1, 1] * pc[:, 1] / z + kmat[1, 2]
            res = np.hypot(u - self.obs_uv[:no, 0], v - self.obs_uv[:no, 1])
            res = np.where(alive_o & (pc[:, 2] > 0), res, np.nan)
            # Median per landmark without a python loop: sort by
            # (landmark, residual) and pick each group's middle entry.
            order = np.lexsort((res, ol))
            ol_s, res_s = ol[order], res[order]
            counts = np.bincount(ol_s, weights=~np.isnan(res_s), minlength=n).astype(np.int64)
            starts = np.concatenate([[0], np.cumsum(np.bincount(ol_s, minlength=n))])[:-1]
            have = counts > 0
            mid = starts + np.maximum(counts - 1, 0) // 2
            med = np.full(n, 0.0)
            med[have] = res_s[np.minimum(mid[have], no - 1)]
            bad = (
                self.lm_alive[:n]
                & have[:n]
                & (med[:n] > c.cull_reproj_mult * c.pnp_inlier_threshold)
            )
            # A landmark with live observations but NO in-front-of-camera
            # residual at all is unconditionally garbage.
            n_live_obs = np.bincount(ol[alive_o], minlength=n)[:n]
            kill = kill | bad | (self.lm_alive[:n] & (n_live_obs > 0) & ~have[:n])
        idx = np.nonzero(kill)[0]
        if len(idx) == 0:
            return 0
        self.lm_alive[idx] = False
        dead_obs = kill[self.obs_lm[: self.n_obs]]
        self.obs_alive[: self.n_obs] &= ~dead_obs
        self.n_culled += len(idx)
        return len(idx)

    @staticmethod
    def _depths(cam: np.ndarray, pts: np.ndarray) -> np.ndarray:
        cam = np.asarray(cam)
        return (pts @ _rot(cam[:3]).T + cam[3:])[:, 2]

    # -- pipeline --------------------------------------------------------
    def _two_view(self, frame0, framew, gen):
        """Match, essential RANSAC, pose recovery and triangulation of a
        frame pair: (m, src_uv, dst_uv, inliers, r, t, pts3) on the host."""
        xy0, d0, v0 = frame0
        xyw, dw, vw = framew
        c = self.config
        m = self._match(d0, dw, v0, vw)
        mv = _np(m.valid)
        # geometry uses (u=col, v=row)
        src_uv = _np(xy0)[:, ::-1].copy()
        dst_uv = _np(xyw)[_np(m.target_idx)][:, ::-1].copy()
        res = find_fundamental(
            gen, self._t(src_uv), self._t(dst_uv), self._t(mv),
            n_hypotheses=c.ransac_hypotheses,
        )
        inl = _np(res.inliers)
        e = essential_from_fundamental(res.model, self.k, self.k)
        kinv = np.linalg.inv(self._k)
        n0 = (np.c_[src_uv, np.ones(len(src_uv))] @ kinv.T)[:, :2]
        n1 = (np.c_[dst_uv, np.ones(len(dst_uv))] @ kinv.T)[:, :2]
        r, t, _ = recover_pose(e, self._t(n0), self._t(n1), self._t(inl * 1.0))
        p0 = self._k @ np.c_[np.eye(3), np.zeros(3)]
        pw = self._k @ np.c_[_np(r), _np(t)]
        pts3 = _np(triangulate(self._t(p0), self._t(pw), self._t(src_uv), self._t(dst_uv)))
        return m, src_uv, dst_uv, inl, r, t, pts3

    def initialize(self, frame0, frame1, generator: Optional[torch.Generator] = None) -> int:
        """Two-view bootstrap. frames are (xy, desc, valid). Returns the
        number of triangulated landmarks."""
        gen = generator if generator is not None else self._gen(0)
        c = self.config
        frame0, frame1 = self._frame(frame0), self._frame(frame1)
        m, src_uv, dst_uv, inl, r, t, pts3 = self._two_view(frame0, frame1, gen)

        cam0 = np.zeros(6, dtype=np.float32)
        cam1 = np.concatenate([_np(so3_log(r)), _np(t)]).astype(np.float32)
        self.cameras[0] = cam0
        self.cameras[1] = cam1
        self.n_cameras = 2

        z0 = pts3[:, 2]
        z1 = (pts3 @ _np(r).T + _np(t))[:, 2]
        good = inl & (z0 > c.triangulation_min_depth) & (z1 > c.triangulation_min_depth)
        if c.triangulation_min_parallax > 0:
            # At init parallax is a PREFERENCE, not a gate (a noise-limited
            # essential matrix on a tiny baseline can leave no point above
            # a hard gate): well-conditioned points first, then a capped
            # degenerate fill. add_frame applies the hard gate.
            pok = _parallax_ok(pts3, cam0, cam1, c.triangulation_min_parallax)
            cand = np.nonzero(good)[0]
            good_c = cand[pok[cand]]
            n_fill = max(0, min(128, c.new_landmarks_per_frame) - len(good_c))
            cand = np.concatenate([good_c, cand[~pok[cand]][:n_fill]])
            sel = np.sort(cand[: c.new_landmarks_per_frame])
        else:
            sel = np.nonzero(good)[0][: c.new_landmarks_per_frame]
        lm_idx = self._add_landmarks(pts3[sel], _np(frame0[1])[sel])
        self._add_observations(np.zeros(len(sel), np.int32), lm_idx, src_uv[sel])
        tgt = _np(m.target_idx)[sel]
        self._add_observations(np.ones(len(sel), np.int32), lm_idx, dst_uv[sel])
        self.frames = [frame0, frame1]
        self.odometry = [self._relative(cam0, cam1)]
        self._frame_lm = {0: (sel, lm_idx), 1: (tgt, lm_idx)}
        return len(sel)

    def _trial_two_view(self, frame0, framew, generator):
        """Trial two-view reconstruction of (frame0, framew): returns
        ``(median_parallax, n_good, pts3, sel_order, src_uv)`` where
        ``sel_order`` ranks candidate landmark rows (parallax-preferred)."""
        c = self.config
        _, src_uv, _, inl, r, t, pts3 = self._two_view(frame0, framew, generator)
        cam0 = np.zeros(6, dtype=np.float32)
        camw = np.concatenate([_np(so3_log(r)), _np(t)]).astype(np.float32)
        z0 = pts3[:, 2]
        zw = (pts3 @ _np(r).T + _np(t))[:, 2]
        good = inl & (z0 > c.triangulation_min_depth) & (zw > c.triangulation_min_depth)
        # Parallax angle between the bearing rays of every good point.
        centers = _camera_centers(np.stack([cam0, camw]))
        r1 = (pts3 - centers[0]).astype(np.float64)
        r2 = (pts3 - centers[1]).astype(np.float64)
        ang = np.arctan2(np.linalg.norm(np.cross(r1, r2), axis=1), (r1 * r2).sum(axis=1))
        n_good = int(good.sum())
        med = float(np.median(ang[good])) if n_good else 0.0
        # Parallax-preferred landmark selection (initialize's policy).
        pok = good & (ang > c.triangulation_min_parallax)
        cand = np.concatenate([
            np.nonzero(pok)[0],
            np.nonzero(good & ~pok)[0][
                : max(0, min(128, c.new_landmarks_per_frame) - int(pok.sum()))
            ],
        ])
        return med, n_good, pts3, np.sort(cand), src_uv

    def initialize_delayed(self, frames, generator: Optional[torch.Generator] = None) -> Tuple[int, int]:
        """ORB-SLAM-style delayed bootstrap.

        ``frames`` is the OPENING keyframe list (at least 2 entries; pass
        up to ~config.bootstrap_max_delay + 1). Searches for the first
        frame w whose trial two-view reconstruction against frame 0 has
        median triangulation parallax >= bootstrap_min_parallax, then
        seeds the map with camera 0 (identity) plus the WIDE pair's
        landmarks only — n_cameras stays 1, so the caller registers
        frames[1:] (including frame w) through ``add_frame`` and camera
        indices remain TEMPORAL. Returns ``(w, n_landmarks)``. Trial w
        draws from ``generator`` when given, else from a generator seeded
        with w."""
        c = self.config
        assert len(frames) >= 2
        frame0 = self._frame(frames[0])
        best = None  # (median_parallax, w, pts3, sel, src_uv)
        w_max = min(len(frames) - 1, max(1, c.bootstrap_max_delay))
        for w in range(1, w_max + 1):
            gen = generator if generator is not None else self._gen(w)
            med, n_good, pts3, sel, src_uv = self._trial_two_view(
                frame0, self._frame(frames[w]), gen
            )
            if n_good < max(32, c.min_pnp_inliers):
                continue
            if best is None or med > best[0]:
                best = (med, w, pts3, sel, src_uv)
            if med >= c.bootstrap_min_parallax:
                break
        assert best is not None, "no usable bootstrap pair found"
        med, w, pts3, sel, src_uv = best
        sel = sel[: c.new_landmarks_per_frame]
        self.cameras[0] = 0.0
        self.n_cameras = 1
        lm_idx = self._add_landmarks(pts3[sel], _np(frame0[1])[sel])
        self._add_observations(np.zeros(len(sel), np.int32), lm_idx, src_uv[sel])
        self.frames = [frame0]
        self.odometry = []
        self._frame_lm = {0: (sel, lm_idx)}
        self._delayed_init = True
        return w, len(sel)

    def add_frame(self, frame, generator: Optional[torch.Generator] = None) -> Tuple[bool, int, int]:
        """Register a new keyframe: PnP against the map + triangulate new
        landmarks vs the previous keyframe.

        Returns ``(ok, n_inliers, n_new)``. When PnP fails (``res.ok``
        false, or fewer than ``config.min_pnp_inliers`` inliers) NOTHING is
        committed — no camera, no observations, no odometry edge."""
        gen = generator if generator is not None else self._gen(self.n_cameras)
        c = self.config
        frame = self._frame(frame)
        xy, desc, valid = frame
        valid_np = _np(valid)
        cam_id = self.n_cameras
        assert cam_id < c.max_cameras, "camera overflow"

        # 2D-3D matches against the FILL bucket of the landmark table.
        nl = _bucket(self.n_landmarks, c.max_landmarks)
        lm_valid = np.zeros(nl, dtype=bool)
        lm_valid[: self.n_landmarks] = self.lm_alive[: self.n_landmarks]
        lm_desc = self._t(self.lm_desc[:nl])
        m = self._match(desc, lm_desc, valid, self._t(lm_valid))
        mv = _np(m.valid).copy()
        lm_ids = _np(m.target_idx).copy()
        uv = _np(xy)[:, ::-1].copy()          # (col, row)
        # Duplicate-aware ratio-test rescue: when the two best map matches
        # are nearly equidistant (a duplicated landmark), disambiguate
        # GEOMETRICALLY in the previous keyframe's pose; RANSAC still
        # arbitrates every rescued correspondence.
        if self.n_cameras > 0 and m.second_idx is not None and c.guided_rematch_radius > 0:
            d1 = _np(m.distance)
            i2 = _np(m.second_idx)
            cand = valid_np & ~mv & (d1 < c.match_absolute_threshold) & (i2 >= 0)
            if cand.any():
                ci = np.nonzero(cand)[0]
                prev_cam = self.cameras[self.n_cameras - 1]

                def reproj_err(lm_i):
                    proj = self._project(prev_cam, self.landmarks[np.maximum(lm_i, 0)])
                    return np.linalg.norm(proj - uv[ci], axis=1)

                b1, b2 = _np(m.best_idx)[ci], i2[ci]
                e1 = np.where(self.lm_alive[np.maximum(b1, 0)], reproj_err(b1), np.inf)
                e2 = np.where(self.lm_alive[np.maximum(b2, 0)], reproj_err(b2), np.inf)
                pick = np.where(e1 <= e2, b1, b2)
                # Accept when (a) the twins are 3D-close relative to their
                # distance from the previous camera, or (b) one twin
                # projects within rescue_reproj_radius there.
                p1 = self.landmarks[np.maximum(b1, 0)]
                p2 = self.landmarks[np.maximum(b2, 0)]
                center = _camera_centers(self.cameras[self.n_cameras - 1: self.n_cameras])[0]
                dist_c = np.maximum(np.linalg.norm(p1 - center, axis=1), 1e-6)
                emin = np.minimum(e1, e2)
                same3d = (
                    (np.linalg.norm(p1 - p2, axis=1) / dist_c < max(c.track_merge_frac, 0.02))
                    & np.isfinite(emin)
                )
                ok_r = same3d | (emin < c.rescue_reproj_radius)
                rescued = ci[ok_r]
                mv[rescued] = True
                lm_ids[rescued] = pick[ok_r]
        pts3 = self.landmarks[np.maximum(lm_ids, 0)]

        res = pnp_ransac(
            gen, self._t(pts3), self._t(uv), self._t(mv), self.k,
            n_hypotheses=c.ransac_hypotheses,
            inlier_threshold=c.pnp_inlier_threshold,
        )
        inl = _np(res.inliers)
        n_in = int(res.n_inliers)
        if not bool(res.ok) or n_in < c.min_pnp_inliers:
            return False, n_in, 0
        cam_new = _np(res.model).astype(np.float32)
        self.cameras[cam_id] = cam_new
        self.n_cameras += 1

        sel = np.nonzero(inl)[0]
        self._add_observations(np.full(len(sel), cam_id, np.int32), lm_ids[sel], uv[sel])
        kp_obs = [sel]
        lm_obs = [lm_ids[sel]]

        # Guided re-matching: project every map landmark into the accepted
        # pose; unmatched keypoints may claim a landmark whose projection
        # falls within the gate.
        if c.guided_rematch_radius > 0:
            proj = self._project(cam_new, self.landmarks[:nl])
            zs = self._depths(cam_new, self.landmarks[:nl])
            observed = np.zeros(nl, bool)
            observed[lm_ids[sel]] = True
            lm_ok = (
                (np.arange(nl) < self.n_landmarks)
                & np.pad(self.lm_alive[: self.n_landmarks], (0, nl - self.n_landmarks))
                & (zs > c.triangulation_min_depth)
                & ~observed
            )
            free_kp = valid_np & ~inl
            gm = match_guided(
                desc, lm_desc, self._t(free_kp), self._t(lm_ok),
                self._t(uv.astype(np.float32)), self._t(proj.astype(np.float32)),
                gate_radius=c.guided_rematch_radius,
                absolute_threshold=c.guided_abs_threshold,
            )
            gv = _np(gm.valid)
            # One observation per landmark: keep the closest descriptor.
            gsel = np.nonzero(gv)[0]
            gtgt = _np(gm.target_idx)[gsel]
            gdist = _np(gm.distance)[gsel]
            seen = set()
            keep = []
            for i in np.argsort(gdist):
                if gtgt[i] not in seen:
                    seen.add(gtgt[i])
                    keep.append(i)
            gsel, gtgt = gsel[keep], gtgt[keep]
            self._add_observations(np.full(len(gsel), cam_id, np.int32), gtgt, uv[gsel])
            kp_obs.append(gsel)
            lm_obs.append(gtgt)
            inl = inl | np.isin(np.arange(len(inl)), gsel)

        # Grow the map: match against the previous keyframe, triangulate
        # pairs that are NOT yet landmarks.
        prev_id = cam_id - 1
        pxy, pdesc, pvalid = self.frames[-1]
        m2 = self._match(desc, pdesc, valid, pvalid)
        m2v = _np(m2.valid) & ~inl  # new points only
        prev_uv = _np(pxy)[_np(m2.target_idx)][:, ::-1]

        cam_prev = self.cameras[prev_id]
        p_new = self._k @ np.c_[_rot(cam_new[:3]), cam_new[3:]]
        p_prev = self._k @ np.c_[_rot(cam_prev[:3]), cam_prev[3:]]
        pts3n = _np(triangulate(
            self._t(p_prev.astype(np.float32)), self._t(p_new.astype(np.float32)),
            self._t(prev_uv.astype(np.float32)), self._t(uv.astype(np.float32)),
        ))
        err = np.linalg.norm(self._project(cam_new, pts3n) - uv, axis=1)
        good = (
            m2v
            & (self._depths(cam_new, pts3n) > c.triangulation_min_depth)
            & (self._depths(cam_prev, pts3n) > c.triangulation_min_depth)
            & (err < c.pnp_inlier_threshold)
        )
        if c.triangulation_min_parallax > 0:
            good &= _parallax_ok(pts3n, cam_prev, cam_new, c.triangulation_min_parallax)
        seln = np.nonzero(good)[0][: c.new_landmarks_per_frame]

        # Track merging: a candidate "new" point whose descriptor matches
        # an EXISTING landmark that reprojects near its keypoint (or lies
        # within track_merge_frac of its depth) is the same physical track
        # re-detected: record an observation instead of a duplicate.
        if c.track_merge_frac > 0 and len(seln) > 0 and self.n_landmarks > 0:
            # ratio_threshold=1.0 disables the Lowe test HERE only: with a
            # duplicate in the map the two best matches ARE the same point.
            mm = self._match(
                self._t(_np(desc)[seln]), lm_desc,
                torch.ones(len(seln), dtype=torch.bool, device=self.device),
                self._t(lm_valid), ratio=1.0,
            )
            mmv = _np(mm.valid)
            tgt_lm = _np(mm.target_idx).copy()
            depth_n = self._depths(cam_new, pts3n[seln])

            def merge_gate(lm_i):
                pts = self.landmarks[np.maximum(lm_i, 0)]
                err2d = np.linalg.norm(self._project(cam_new, pts) - uv[seln], axis=1)
                d3 = np.linalg.norm(pts3n[seln] - pts, axis=1)
                # Wider than the PnP inlier gate: an old landmark carries
                # the windowed-BA drift accumulated since its creation.
                return (err2d < c.track_merge_reproj_radius) | (
                    d3 < c.track_merge_frac * np.maximum(depth_n, 1e-6)
                )

            g1 = merge_gate(tgt_lm)
            # Duplicate-aware retarget: retry the gate on the second-best
            # when it also clears the absolute threshold.
            i2 = _np(mm.second_idx)
            d2nd = _np(mm.second_distance)
            retry = mmv & ~g1 & (i2 >= 0) & (d2nd < c.match_absolute_threshold)
            g2 = np.zeros_like(g1)
            if retry.any():
                g2 = retry & merge_gate(i2) & self.lm_alive[np.maximum(i2, 0)]
                tgt_lm = np.where(g2, i2, tgt_lm)
            merge = mmv & (g1 | g2)
            midx = np.nonzero(merge)[0]
            if len(midx):
                self._add_observations(
                    np.full(len(midx), cam_id, np.int32), tgt_lm[midx], uv[seln[midx]]
                )
                kp_obs.append(seln[midx])
                lm_obs.append(tgt_lm[midx])
                seln = seln[~merge]

        budget = self.config.max_landmarks - self.n_landmarks
        seln = seln[:budget]
        lm_idx = self._add_landmarks(pts3n[seln], _np(desc)[seln])
        self._add_observations(np.full(len(seln), prev_id, np.int32), lm_idx, prev_uv[seln])
        self._add_observations(np.full(len(seln), cam_id, np.int32), lm_idx, uv[seln])
        kp_obs.append(seln)
        lm_obs.append(lm_idx)
        self.frames.append(frame)
        self._frame_lm[cam_id] = (
            np.concatenate([np.asarray(a, np.int32) for a in kp_obs]),
            np.concatenate([np.asarray(a, np.int32) for a in lm_obs]),
        )
        self.odometry.append(self._relative(cam_prev, cam_new))
        self.cull_landmarks()
        if (
            c.init_reanchor_at > 0
            and cam_id == c.init_reanchor_at
            and not getattr(self, "_delayed_init", False)
        ):
            # Delayed-bootstrap landmarks already carry a wide baseline.
            self._retriangulate_init()
        return True, n_in, len(seln)

    def _retriangulate_init(self) -> int:
        """Re-triangulate init-generation landmarks from their (frame 0,
        latest frame) observation pair with the CURRENT pose estimates
        (see SfmConfig.init_reanchor_at); then re-solve every non-anchor
        pose, run one global BA and re-derive the odometry. Positions that
        fail the depth/reprojection checks keep their old value. Returns
        the number of landmarks updated."""
        c = self.config
        no = self.n_obs
        if no == 0 or self.n_landmarks == 0:
            return 0
        n = self.n_landmarks
        ol = self.obs_lm[:no]
        oc = self.obs_cam[:no]
        ouv = self.obs_uv[:no]
        alive_o = self.obs_alive[:no]
        # Init-generation landmarks carry created <= 1.
        init_lm = (self.lm_created[:n] <= 1) & self.lm_alive[:n]

        sel0 = alive_o & (oc == 0) & init_lm[ol]
        uv0 = np.zeros((n, 2), np.float32)
        has0 = np.zeros(n, bool)
        uv0[ol[sel0]] = ouv[sel0]
        has0[ol[sel0]] = True

        latest = np.full(n, -1, np.int32)
        np.maximum.at(latest, ol[alive_o], oc[alive_o])
        sel_l = alive_o & (oc == latest[ol]) & init_lm[ol] & (oc >= 2)
        uvl = np.zeros((n, 2), np.float32)
        hasl = np.zeros(n, bool)
        uvl[ol[sel_l]] = ouv[sel_l]
        hasl[ol[sel_l]] = True

        cand = has0 & hasl
        if not cand.any():
            return 0

        def projmat(cam):
            return (self._k @ np.c_[_rot(cam[:3]), cam[3:]]).astype(np.float32)

        p0 = projmat(self.cameras[0])
        updated = 0
        for j in np.unique(latest[cand]):
            rows = np.nonzero(cand & (latest == j))[0]
            pts = _np(triangulate(
                self._t(p0), self._t(projmat(self.cameras[j])),
                self._t(uv0[rows]), self._t(uvl[rows]),
            ))
            z0 = self._depths(self.cameras[0], pts)
            zj = self._depths(self.cameras[j], pts)
            err = np.linalg.norm(self._project(self.cameras[j], pts) - uvl[rows], axis=1)
            ok = (
                (z0 > c.triangulation_min_depth)
                & (zj > c.triangulation_min_depth)
                & (err < c.pnp_inlier_threshold)
                & np.isfinite(pts).all(axis=1)
            )
            self.landmarks[rows[ok]] = pts[ok]
            updated += int(ok.sum())

        if updated:
            # The early poses were estimated against the pre-repair
            # geometry: re-solve each on its own observations, then one
            # global BA (the map is ~init_reanchor_at keyframes here).
            for j in range(1, self.n_cameras):
                sel = alive_o & (oc == j)
                if sel.sum() < 6:
                    continue
                self.cameras[j] = _np(pnp_refine(
                    self._t(self.cameras[j]), self._t(self.landmarks[ol[sel]]),
                    self._t(ouv[sel]), self.k,
                    torch.ones(int(sel.sum()), device=self.device),
                ))
            self.bundle_adjust(fixed_cameras=1)
            # The stored odometry was measured against the PRE-repair
            # poses: re-derive it from the repaired ones.
            for j in range(len(self.odometry)):
                self.odometry[j] = self._relative(self.cameras[j], self.cameras[j + 1])
        return updated

    def detect_loop_closures(self, generator: Optional[torch.Generator] = None):
        """Propose + verify loop-closure edges for the LATEST keyframe.

        For each older keyframe j with temporal gap >= loop_min_gap (the
        loop_max_candidates nearest by camera center, one per temporal
        cluster): descriptor matching against j's keypoints PROPOSES a
        closure (>= loop_min_matches ratio-test survivors); PnP of the
        current frame's keypoints against the landmarks OBSERVED FROM j
        verifies it and measures the relative pose. Outlier gates:
        conditioning (inlier pixels spread >= loop_min_uv_spread in both
        axes), consensus (each candidate pose re-scored on the union of
        all closures' 2D-3D sets, kept at >= 0.8 of the best) and a MAD
        gate around the median pose.

        Returns a list of (j, i, rel_ij[6]) edges ready for
        ``optimize_pose_graph``."""
        c = self.config
        gen = generator if generator is not None else self._gen(1234)
        i = self.n_cameras - 1
        xy, desc, valid = self.frames[i]
        uv = _np(xy)[:, ::-1].astype(np.float32)
        cands = []  # (j, model[6])
        union_ok = np.zeros(len(uv), dtype=bool)
        union_lm = np.full(len(uv), -1, np.int64)
        eligible = [j for j in range(0, i - c.loop_min_gap + 1) if j in self._frame_lm]
        if c.loop_max_candidates and len(eligible) > c.loop_max_candidates:
            # Pose-proximity shortlist with temporal diversity: greedily
            # the nearest candidate of each loop_min_gap-wide cluster.
            centers = _camera_centers(self.cameras[np.asarray(eligible + [i])])
            dists = np.linalg.norm(centers[:-1] - centers[-1], axis=1)
            keep = []
            for t in np.argsort(dists):
                if any(abs(eligible[t] - eligible[u]) < c.loop_min_gap for u in keep):
                    continue
                keep.append(t)
                if len(keep) >= c.loop_max_candidates:
                    break
            eligible = [eligible[t] for t in sorted(keep)]
        if not eligible:
            return []
        # ONE batched matcher dispatch for all shortlisted candidates
        # (keyframe descriptor buffers share the budget's shape): no host
        # read per candidate. PnP verification stays per candidate: it is
        # gated on the data-dependent match counts below.
        m_all = torch.func.vmap(
            lambda pd, pv: self._match(desc, pd, valid, pv)
        )(
            torch.stack([self.frames[j][1] for j in eligible]),
            torch.stack([self.frames[j][2] for j in eligible]),
        )
        m_valids = _np(m_all.valid)
        m_counts = m_valids.sum(axis=1)
        m_tgts = _np(m_all.target_idx)
        for t, j in enumerate(eligible):
            if int(m_counts[t]) < c.loop_min_matches:
                continue
            # 2D-3D: current keypoints matched to j-keypoints that carry
            # landmarks.
            kp_j, lm_j = self._frame_lm[j]
            kp2lm = np.full(self.frames[j][2].shape[0], -1, np.int64)
            kp2lm[kp_j] = lm_j
            lm_of_match = kp2lm[np.maximum(m_tgts[t], 0)]
            ok2d3d = (
                m_valids[t]
                & (lm_of_match >= 0)
                & self.lm_alive[np.maximum(lm_of_match, 0)]
            )
            if ok2d3d.sum() < c.loop_min_inliers:
                continue
            pts3 = self.landmarks[np.maximum(lm_of_match, 0)]
            res = pnp_ransac(
                gen, self._t(pts3), self._t(uv), self._t(ok2d3d), self.k,
                n_hypotheses=c.ransac_hypotheses,
                inlier_threshold=c.pnp_inlier_threshold,
            )
            n_in = int(res.n_inliers)
            if not bool(res.ok) or n_in < c.loop_min_inliers:
                continue
            inl_uv = uv[_np(res.inliers)]
            if len(inl_uv) and inl_uv.std(axis=0).min() < c.loop_min_uv_spread:
                continue
            union_ok |= ok2d3d
            union_lm = np.where(ok2d3d, lm_of_match, union_lm)
            cands.append((j, _np(res.model).astype(np.float32)))

        if not cands:
            return []
        # Reprojection consensus: all candidates estimate the SAME pose,
        # so score each on the union 2D-3D set.
        upts3 = self.landmarks[np.maximum(union_lm, 0)]
        scores = []
        for _, mdl in cands:
            err = np.linalg.norm(self._project(mdl, upts3) - uv, axis=1)
            scores.append(int((union_ok & (err < c.pnp_inlier_threshold)).sum()))
        best = max(scores)
        kept = [(j, mdl) for score, (j, mdl) in zip(scores, cands) if score >= 0.8 * best]
        # Mutual pose agreement: robust MAD gate around the median pose.
        if len(kept) >= 3:
            models = np.stack([m for _, m in kept])
            med = np.median(models, axis=0)
            dev = np.linalg.norm(models - med, axis=1)
            mad = np.median(dev)
            keep_mask = dev <= 5.0 * max(mad, 0.01)
            kept = [km for km, k_ok in zip(kept, keep_mask) if k_ok]
        return [(j, i, self._relative(self.cameras[j], mdl)) for j, mdl in kept]

    def _problem(self, valid: np.ndarray, nc: int, nlm: int, no: int, fixed: int) -> BAProblem:
        return BAProblem(
            cameras=self._t(self.cameras[:nc]),
            landmarks=self._t(self.landmarks[:nlm]),
            k=self.k,
            cam_idx=self._t(self.obs_cam[:no]),
            lm_idx=self._t(self.obs_lm[:no]),
            uv=self._t(self.obs_uv[:no]),
            valid=self._t(valid),
            fixed_cameras=fixed,
        )

    def _fill(self):
        c = self.config
        nc = _bucket(self.n_cameras, c.max_cameras)
        nlm = _bucket(self.n_landmarks, c.max_landmarks)
        no = _bucket(self.n_obs, c.max_observations)
        valid = np.zeros(no, dtype=bool)
        valid[: self.n_obs] = self.obs_alive[: self.n_obs]
        return valid, nc, nlm, no

    def bundle_adjust(self, fixed_cameras: Optional[int] = None, window: Optional[int] = None):
        """Bundle adjustment over the current map on its FILL buckets
        (next pow2 >= each fill count, capped at its budget).

        ``fixed_cameras`` defaults to 1 (SE(3) gauge only; fixing more, or
        promoting windowed calls to global ones, measured worse in the
        JAX package). ``window=k`` selects sliding-window LOCAL BA: only
        the last k keyframes move and only observations of landmarks seen
        by at least one window camera participate; landmarks seen only by
        fixed cameras stay exactly put."""
        if fixed_cameras is None:
            fixed_cameras = 1
        c = self.config
        valid, nc, nlm, no = self._fill()
        if window is not None:
            first_free = max(fixed_cameras, self.n_cameras - window)
            fixed_cameras = first_free
            in_window = self.obs_cam[: self.n_obs] >= first_free
            lm_in_window = np.zeros(nlm, dtype=bool)
            lm_in_window[self.obs_lm[: self.n_obs][in_window]] = True
            valid[: self.n_obs] &= lm_in_window[self.obs_lm[: self.n_obs]]
        out, stats = bundle_adjust(
            self._problem(valid, nc, nlm, no, fixed_cameras),
            n_iterations=c.ba_iterations, huber_delta=c.ba_huber_delta,
        )
        self.cameras[:nc] = _np(out.cameras)
        self.landmarks[:nlm] = _np(out.landmarks)
        # Refresh the stored odometry over the adjusted range so the pose
        # graph anchors to the REFINED chain.
        first = 0 if window is None else max(0, fixed_cameras - 1)
        for i in range(first, self.n_cameras - 1):
            self.odometry[i] = self._relative(self.cameras[i], self.cameras[i + 1])
        return stats

    def optimize_pose_graph(self, loop_closures: Optional[list] = None, n_iterations: int = 20):
        """Pose-graph optimization over the keyframe chain.

        Edges: the odometry measurements RECORDED at registration plus
        optional ``loop_closures`` — (i, j, rel_ij[6]) or (i, j) pairs,
        where a bare pair measures the CURRENT relative pose. Landmarks
        are re-anchored by a subsequent ``bundle_adjust()``. Returns the
        final cost."""
        n = self.n_cameras
        assert n >= 2, "need at least two keyframes"
        ei = list(range(n - 1))
        ej = list(range(1, n))
        rels = [np.asarray(r) for r in self.odometry[: n - 1]]
        for lc in loop_closures or []:
            if len(lc) == 2:
                i, j = lc
                rel = self._relative(self.cameras[i], self.cameras[j])
            else:
                i, j, rel = lc
                rel = _np(rel)
            ei.append(i)
            ej.append(j)
            rels.append(rel)

        # Pad poses and edges to fill buckets. Padding edges carry weight
        # 0; padded poses have no edges and are pinned by the damping.
        c = self.config
        nc = _bucket(n, c.max_cameras)
        m = len(ei)
        me = _bucket(m, max(2 * c.max_cameras, m))
        poses = np.zeros((nc, 6), np.float32)
        poses[:n] = self.cameras[:n]
        edge_i = np.zeros(me, np.int32)
        edge_j = np.zeros(me, np.int32)
        rel_ij = np.zeros((me, 6), np.float32)
        weight = np.zeros(me, np.float32)
        edge_i[:m] = ei
        edge_j[:m] = ej
        rel_ij[:m] = np.stack(rels).astype(np.float32)
        weight[:m] = 1.0
        # Scalar Huber for EVERY edge, loop closures included (trusting
        # verified closures with inf measured harmful in the JAX package).
        g = PoseGraph(
            poses=self._t(poses), edge_i=self._t(edge_i), edge_j=self._t(edge_j),
            rel_ij=self._t(rel_ij), weight=self._t(weight), fixed=1,
        )
        huber = torch.full((me,), 0.1, device=self.device)
        out, cost = _optimize_pose_graph(g, n_iterations=n_iterations, huber_delta=huber)
        self.cameras[:n] = _np(out.poses)[:n]
        return float(cost)

    def reprojection_rms(self) -> float:
        valid, nc, nlm, no = self._fill()
        r = _np(residuals(self._problem(valid, nc, nlm, no, 1)))
        n_live = int(self.obs_alive[: self.n_obs].sum())
        return float(np.sqrt((r ** 2).sum() / max(n_live, 1)))
