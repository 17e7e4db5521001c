"""LLFF pose pipeline (poses_bounds.npy handling) for DyNeRF scenes.

The port's copy of cednerf_tpu/datasets/llff.py (host-side numpy,
unchanged), held against the original by tests/test_torch_datasets.py.

Math parity with the reference's datasets/pose_ulils.py (sic):
  * average_poses / center_poses (pose_ulils.py:14-60) — note this variant
    builds the average rotation with x = normalize(cross(y', z)), y = cross(z, x)
    (different sign convention from datasets/utils.py's average_poses; both are
    kept because DyNeRF centering uses this one and the spiral path the other);
  * correct_poses_bounds (pose_ulils.py:230-255): "down right back" ->
    "right up back" axis flip, scale by 0.75 * min(bounds), recenter by the
    inverse average pose;
  * se(3) twist log/exp + pose interpolation (pose_ulils.py:269-356) — the
    reference goes through scipy logm/expm on full 4x4 matrices; here the
    same twists come from the closed-form SO(3)/SE(3) log/exp (Rodrigues +
    the V matrix), which is exact for rigid transforms and needs no scipy.
"""

import numpy as np

from .rays import viewmatrix


def _normalize(v):
    return v / np.linalg.norm(v)


def average_poses_llff(poses):
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    rot = np.stack([x, y, z], 1)
    return np.concatenate([rot, center[:, None]], 1)  # (3, 4)


def center_poses(poses):
    """Recenter poses about their average (pose_ulils.py:48-60)."""
    pose_avg = average_poses_llff(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (np.linalg.inv(pose_avg_homo) @ poses_homo)[:, :3]
    return poses_centered, np.linalg.inv(pose_avg_homo)


def correct_poses_bounds(poses, bounds, flip=True, center=True):
    """LLFF pose normalization (pose_ulils.py:230-255)."""
    if flip:
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1
        )
    scale_factor = bounds.min() * 0.75
    bounds = bounds / scale_factor
    poses = poses.copy()
    poses[..., :3, 3] /= scale_factor
    if center:
        poses, ref = center_poses(poses)
    else:
        ref = poses[0]
    return poses, ref, bounds


def center_poses_with(poses, train_poses, avg_pose=None):
    """Center `poses` by the average of `train_poses` (pose_ulils.py:62-78).

    When `avg_pose` (an inverse 4x4) is given it is applied directly — the
    reference uses this to re-apply a previously computed centering to a
    second split.
    """
    if avg_pose is None:
        pose_avg_homo = np.eye(4)
        pose_avg_homo[:3] = average_poses_llff(train_poses)
        inv_pose = np.linalg.inv(pose_avg_homo)
    else:
        inv_pose = np.array(avg_pose, copy=True)
    centered = np.einsum("ij,njk->nik", inv_pose, p34_to_44(poses))[:, :3]
    return centered, inv_pose


def center_poses_with_rotation_only(poses, train_poses):
    """Like center_poses_with but aligns rotation only — the average
    translation is left in place (pose_ulils.py:80-92)."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3, :3] = average_poses_llff(train_poses)[:3, :3]
    inv_pose = np.linalg.inv(pose_avg_homo)
    centered = np.einsum("ij,njk->nik", inv_pose, p34_to_44(poses))[:, :3]
    return centered, inv_pose


def center_poses_reference(poses):
    """Center about the *actual camera* closest to the average pose rather
    than the synthetic average itself (pose_ulils.py:94-112)."""
    pose_avg = average_poses_llff(poses)
    poses_homo = p34_to_44(poses)
    dists = np.sum(np.square(pose_avg[:3, 3] - poses[:, :3, 3]), -1)
    ref = poses_homo[np.argmin(dists)]
    inv_pose = np.linalg.inv(ref)
    centered = np.einsum("ij,njk->nik", inv_pose, poses_homo)[:, :3]
    return centered, inv_pose


# ----------------------------------------------------------------------- #
# Render-path generators (pose_ulils.py:114-227). Vectorized over the
# frame axis instead of the reference's per-frame Python loops.
# ----------------------------------------------------------------------- #


def create_spiral_poses(poses, rads, focal, n_frames=120, flip=False):
    """LLFF-style spiral about the average pose (pose_ulils.py:162-183).

    Note: the reference's `rads += np.array(list(rads) + [1.])` is a shape
    bug (3 += 4) — the intent, as in create_rotating_spiral_poses, is to
    append the homogeneous 1; implemented that way here (bug documented,
    not reproduced). Unused by the reference pipelines (its DyNeRF loader
    calls generate_spiral_path instead) but part of the public surface.
    """
    c2w = average_poses_llff(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    rads = np.append(np.asarray(rads, np.float64), 1.0)
    thetas = np.linspace(0.0, 2.0 * np.pi * 2, n_frames + 1)[:-1]
    circ = np.stack([np.cos(thetas), -np.sin(thetas),
                     -np.sin(thetas * 0.5), np.ones_like(thetas)], -1)
    centers = circ * rads @ c2w[:3, :4].T                       # [n, 3]
    focus = c2w[:3, :4] @ np.array([0, 0, focal if flip else -focal, 1.0])
    out = []
    for c in centers:
        z = _normalize((focus - c) if flip else (c - focus))
        out.append(viewmatrix(z, up, c))
    return out


def create_rotating_spiral_poses(camera_offset, poses, pose_rad, spiral_rads,
                                 focal, theta_range, n_frames=240, rots=4):
    """Cylindrical orbit whose camera additionally spirals about its own
    center (pose_ulils.py:114-160)."""
    camera_offset = np.asarray(camera_offset, np.float64)
    up = _normalize(poses[:, :3, 1].sum(0))
    spiral_rads = np.append(np.asarray(spiral_rads, np.float64), 1.0)
    pose_thetas = np.linspace(np.pi * theta_range[0], np.pi * theta_range[1],
                              n_frames, endpoint=False)
    spiral_thetas = np.linspace(0.0, 2.0 * np.pi * rots, n_frames,
                                endpoint=False)
    out = []
    for pt, st in zip(pose_thetas, spiral_thetas):
        center = np.array([np.sin(pt) * pose_rad, 0.0,
                           -np.cos(pt) * pose_rad])
        c2w = viewmatrix(-center, up, center + camera_offset)
        c = c2w[:3, :4] @ (np.array([np.cos(st), -np.sin(st),
                                     -np.sin(st * 0.5), 1.0]) * spiral_rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(viewmatrix(z, up, c))
    return out


def create_spherical_poses(radius, n_poses=120, phi=-np.pi / 5):
    """Inward-looking ring of poses on a sphere, 36 degrees downward by
    default (pose_ulils.py:185-227). Returns [n, 3, 4]."""
    thetas = np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
    trans = np.eye(4)
    trans[1, 3] = -0.9 * radius
    trans[2, 3] = radius
    rot_phi = np.eye(4)
    rot_phi[1, 1] = rot_phi[2, 2] = np.cos(phi)
    rot_phi[1, 2], rot_phi[2, 1] = -np.sin(phi), np.sin(phi)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0],
                     [0, 1, 0, 0], [0, 0, 0, 1.0]])
    out = []
    for th in thetas:
        rot_theta = np.eye(4)
        rot_theta[0, 0] = rot_theta[2, 2] = np.cos(th)
        rot_theta[0, 2], rot_theta[2, 0] = -np.sin(th), np.sin(th)
        out.append((flip @ rot_theta @ rot_phi @ trans)[:3])
    return np.stack(out, 0)


def get_bounding_sphere(poses):
    """Max camera distance from the origin (pose_ulils.py:258-260)."""
    return np.linalg.norm(poses[:, :3, -1], axis=-1).max()


def get_bounding_box(poses):
    """[min_xyz, max_xyz] of the camera centers (pose_ulils.py:262-267)."""
    lo = poses[:, :3, -1].min(0)
    hi = poses[:, :3, -1].max(0)
    return [lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]]


# ----------------------------------------------------------------------- #
# se(3) twist helpers + pose interpolation (pose_ulils.py:269-356).
# Twist layout matches the reference: [wx, wy, wz, vx, vy, vz] with
# M = [[skew(w), v], [0, 0]] = logm(pose).
# ----------------------------------------------------------------------- #


def _skew(w):
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    o = np.zeros_like(w[..., 0])
    return np.stack([
        np.stack([o, -w[..., 2], w[..., 1]], -1),
        np.stack([w[..., 2], o, -w[..., 0]], -1),
        np.stack([-w[..., 1], w[..., 0], o], -1),
    ], -2)


def p34_to_44(poses):
    """[N, 3, 4] -> [N, 4, 4] homogeneous (pose_ulils.py:269-272)."""
    bottom = np.broadcast_to(
        np.array([0, 0, 0, 1.0]), (*poses.shape[:-2], 1, 4))
    return np.concatenate([poses, bottom], axis=-2)


def poses_to_twists(poses):
    """SE(3) log of [N, 4, 4] rigid poses -> [N, 6] twists.

    Closed form (Rodrigues inverse + the V^-1 matrix) instead of the
    reference's scipy.linalg.logm (pose_ulils.py:274-292); rotations within
    ~1e-3 of a half-turn fall back to a diagonal-based axis extraction where
    (R - R^T) degenerates.
    """
    poses = np.asarray(poses, np.float64)
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    cos = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)                                   # [N]
    sin = np.sin(theta)
    # vee(R - R^T) = 2 sin(theta) * axis
    vee = np.stack([R[:, 2, 1] - R[:, 1, 2],
                    R[:, 0, 2] - R[:, 2, 0],
                    R[:, 1, 0] - R[:, 0, 1]], -1)
    small = theta < 1e-6
    near_pi = theta > np.pi - 1e-3
    # generic: w = theta / (2 sin theta) * vee; small-angle limit 0.5 * vee
    scale = np.where(small, 0.5, theta / np.maximum(2.0 * sin, 1e-300))
    w = scale[:, None] * vee
    if near_pi.any():
        # near pi (R - R^T degenerates): axis from the exact identity
        # (R + R^T)/2 = I + (1 - cos) (aa^T - I)  =>
        # aa^T = ((R + R^T)/2 - cos I) / (1 - cos)
        Rp = R[near_pi]
        th = theta[near_pi]
        cp = cos[near_pi]
        A = ((Rp + np.swapaxes(Rp, 1, 2)) / 2.0
             - cp[:, None, None] * np.eye(3)) / (1.0 - cp)[:, None, None]
        k = np.argmax(np.diagonal(A, axis1=1, axis2=2), axis=-1)
        rows = A[np.arange(len(Rp)), :, k]
        axis = rows / np.linalg.norm(rows, axis=-1, keepdims=True)
        # sign fixed against vee (vee ~ 2 sin(theta) axis, tiny but signed)
        flip_sign = np.sum(axis * vee[near_pi], -1) < 0
        axis[flip_sign] *= -1.0
        w[near_pi] = th[:, None] * axis
    W = _skew(w)
    th2 = np.maximum(theta, 1e-12) ** 2
    # V^-1 = I - W/2 + (1/theta^2 - (1 + cos)/(2 theta sin)) W^2
    coef = np.where(
        small, 1.0 / 12.0,
        (1.0 / th2) - (1.0 + cos) / np.maximum(2.0 * theta * sin, 1e-300))
    Vinv = (np.eye(3) - W / 2.0 + coef[:, None, None] * (W @ W))
    v = np.einsum("nij,nj->ni", Vinv, t)
    return np.concatenate([w, v], -1)


def twists_to_poses(twists):
    """SE(3) exp of [N, 6] twists -> [N, 4, 4] rigid poses
    (closed-form counterpart of pose_ulils.py:294-356)."""
    twists = np.asarray(twists, np.float64)
    w, v = twists[:, :3], twists[:, 3:]
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-6
    th = np.maximum(theta, 1e-12)
    W = _skew(w)
    W2 = W @ W
    a = np.where(small, 1.0, np.sin(th) / th)                 # sin t / t
    b = np.where(small, 0.5, (1.0 - np.cos(th)) / th ** 2)    # (1-cos)/t^2
    c = np.where(small, 1.0 / 6.0, (th - np.sin(th)) / th ** 3)
    R = np.eye(3) + a[:, None, None] * W + b[:, None, None] * W2
    V = np.eye(3) + b[:, None, None] * W + c[:, None, None] * W2
    t = np.einsum("nij,nj->ni", V, v)
    out = np.broadcast_to(np.eye(4), (len(twists), 4, 4)).copy()
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out


def interpolate_poses(poses, supersample: int):
    """Linear twist-space interpolation between consecutive poses.

    poses: [N, 3, 4]; returns [N * supersample, 3, 4] — `supersample` steps
    between each consecutive pair, last pose repeated (the reference's
    render-path densifier, pose_ulils.py:337-356).
    """
    poses = np.asarray(poses, np.float64)
    twists = poses_to_twists(p34_to_44(poses))
    t = np.linspace(0, 1, supersample, endpoint=False).reshape(1, -1, 1)
    interp = (1 - t) * twists[:-1, None] + t * twists[1:, None]
    interp = interp.reshape(-1, 6)
    interp = np.concatenate(
        [interp, np.tile(twists[-1:], (supersample, 1))], 0)
    return twists_to_poses(interp)[:, :3, :4].astype(np.float32)
