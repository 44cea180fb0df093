"""A sliding-window problem from the analytic simulator, built once with the
reference (vil_fusion_tpu) and carried to the port, for the estimator's
parity tests (test_torch_ba.py, test_torch_marginalization.py,
test_torch_estimator.py).

The window is the ground truth of K frames along sim.Trajectory at 10 Hz
(or a perturbed copy), with preintegrated 200 Hz IMU segments, features
seen in at least three frames and exact LiDAR relative poses, as
tests/test_ba.py builds it, at a small feature capacity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vil_fusion_tpu.models import imu as jimu
from vil_fusion_tpu.models import window as jwin
from vil_fusion_tpu.ops import lie as jlie
from vil_fusion_tpu.runtime import sim
from vil_fusion_tpu_torch.models import ba as tba
from vil_fusion_tpu_torch.models import window as twin
from vil_fusion_tpu_torch.utils import state_io

K = jwin.K
FRAME_DT = 0.1
IMU_RATE = 200.0
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def make_problem(f_cap=32, n_landmarks=120, imu_cap=32, seed=0, depth_noise=0.0):
    """(state_gt, feats, pre, lidar) as JAX NamedTuples."""
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    traj = sim.Trajectory()
    world = sim.LandmarkWorld(n=n_landmarks, seed=seed)
    ts = 1.0 + np.arange(K) * FRAME_DT
    qs = np.stack([traj.pose(t)[0] for t in ts])
    ps = np.stack([traj.pose(t)[1] for t in ts])
    vs = np.stack([traj.velocity(t) for t in ts])
    state = jwin.init_window(f32)._replace(
        p=jnp.asarray(ps, f32), q=jnp.asarray(qs, f32), v=jnp.asarray(vs, f32),
        qic=jnp.asarray(sim.R_to_q(R_BC), f32))

    pre = jwin.init_preint(imu_cap, f32)
    rows = [jax.tree.map(lambda a: a[0], pre._asdict())]
    for i in range(1, K):
        _, acc, gyr = sim.simulate_imu(traj, ts[i - 1], ts[i], IMU_RATE)
        n = len(acc)
        acc_b = np.zeros((imu_cap, 3), np.float32)
        gyr_b = np.zeros((imu_cap, 3), np.float32)
        dt_b = np.zeros((imu_cap - 1,), np.float32)
        acc_b[:n], gyr_b[:n] = acc, gyr
        acc_b[n:], gyr_b[n:] = acc[-1], gyr[-1]
        dt_b[: n - 1] = 1.0 / IMU_RATE
        rows.append(jwin.make_segment(jnp.asarray(acc_b), jnp.asarray(gyr_b), jnp.asarray(dt_b),
                                      jnp.int32(n), jnp.zeros(3, f32), jnp.zeros(3, f32),
                                      jimu.ImuNoise(), imu_cap))
    pre = jwin.StackedPreint(**{k: jnp.stack([jnp.asarray(r[k]) for r in rows])
                                for k in pre._asdict()})

    obs = np.zeros((f_cap, K, 2), np.float32)
    obs_valid = np.zeros((f_cap, K), bool)
    start = np.zeros(f_cap, np.int32)
    inv_depth = np.full(f_cap, -1.0, np.float32)
    per_frame = []
    for t in ts:
        ids, xy, z = sim.project_landmarks(world, traj.rotation(t), traj.position(t), R_bc=R_BC)
        per_frame.append(dict(zip(ids.tolist(), zip(xy, z))))
    slot = 0
    for lm in range(n_landmarks):
        frames = [i for i in range(K) if lm in per_frame[i]]
        if len(frames) < 3 or slot >= f_cap:
            continue
        for i in frames:
            obs[slot, i] = per_frame[i][lm][0]
            obs_valid[slot, i] = True
        start[slot] = frames[0]
        inv_depth[slot] = 1.0 / (per_frame[frames[0]][lm][1] * (1 + depth_noise * rng.normal()))
        slot += 1
    active = np.arange(f_cap) < slot
    feats = jwin.init_features(f_cap, f32)._replace(
        obs=jnp.asarray(obs), obs_valid=jnp.asarray(obs_valid), start=jnp.asarray(start),
        inv_depth=jnp.asarray(inv_depth), active=jnp.asarray(active),
        feat_id=jnp.asarray(np.where(active, np.arange(f_cap), -1).astype(np.int32)))

    q_rel = np.zeros((K, 4), np.float32)
    p_rel = np.zeros((K, 3), np.float32)
    q_rel[:, 0] = 1.0
    for i in range(1, K):
        qr, pr = jlie.pose_between((jnp.asarray(qs[i - 1], f32), jnp.asarray(ps[i - 1], f32)),
                                   (jnp.asarray(qs[i], f32), jnp.asarray(ps[i], f32)))
        q_rel[i], p_rel[i] = np.asarray(qr), np.asarray(pr)
    lidar = jwin.LidarConstraints(q_rel=jnp.asarray(q_rel), p_rel=jnp.asarray(p_rel),
                                  valid=jnp.asarray(np.arange(K) > 0))
    return state, feats, pre, lidar


def perturb(state, seed=1, pos_sig=0.05, rot_sig=0.01, vel_sig=0.05):
    """Perturb frames 1..K-1 of a JAX window (frame 0 anchors the gauge)."""
    rng = np.random.default_rng(seed)
    dp = rng.normal(0, pos_sig, (K, 3)).astype(np.float32)
    dth = rng.normal(0, rot_sig, (K, 3)).astype(np.float32)
    dv = rng.normal(0, vel_sig, (K, 3)).astype(np.float32)
    dp[0] = dth[0] = dv[0] = 0
    q_new, p_new = jlie.pose_retract((state.q, state.p), jnp.asarray(np.concatenate([dp, dth], -1)))
    return state._replace(p=p_new, q=q_new, v=state.v + jnp.asarray(dv))


_CLASSES = dict(window=twin.WindowState, feats=twin.FeatureStore, pre=twin.StackedPreint,
                lidar=twin.LidarConstraints, prior=tba.MargPrior)


def to_port(kind: str, x, device="cpu"):
    """A JAX estimator NamedTuple -> the port's, through numpy."""
    return state_io.to_torch(_CLASSES[kind], state_io.to_numpy(x), device)


def np_(x):
    """Tensor or JAX array -> numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
