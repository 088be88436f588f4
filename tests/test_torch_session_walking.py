"""The port's live session walking and standing over the native UDP runtime.

Counterpart of tests/test_session_walking.py for the port: a plant
thread publishes raw sensors (joints, IMU, and the truth odometry
where asked) over the pf_runtime wire, the port's ``ControlSession``
(on CPU tensors here) estimates or reads the base state and commands the
joints, and the plant steps the SRBD dynamics from the received commands.
The JAX tests' iteration counts and quality bands.

:class:`WirePlant` (the plant of tests/test_session_walking.py:36-213 in
torch, on the CPU), :class:`ScriptedLink` (an in-process link that replays
a fixed sensor sequence and records what the session sends) and
:func:`scripted_sensors` are shared with chip_smoke.py and
tools/session_latency_torch.py: this module imports only torch and numpy
at the top.
"""

import fcntl
import threading
import time

import numpy as np
import pytest
import torch

from mpc_limx_control_tpu_torch import runtime as rt
from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.control import session as ses
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.models import kinematics as kin
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.utils import rotations as rot


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _mtv(R, v):
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def make_plant_step(cfg: ControllerConfig):
    """Single-scenario SRBD plant step driven by a received joint command,
    on CPU tensors of batch 1 (the JAX test's ``_make_plant_step``): the
    stance GRF reconstructed from the commanded stance torques
    (f_body = -(J^T)^-1 tau), the SRBD stepped, the swing leg executing
    its command and the stance foot pinned (walking) or both feet pinned
    (standing), and the sensors a robot would measure synthesized."""
    dtype = torch.float32
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, "cpu")
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, "cpu")
    dt = cfg.gait.dt
    g_vec = torch.tensor([0.0, 0.0, -9.81], dtype=dtype)

    def force(J, tau):
        return -torch.linalg.solve(J.transpose(-1, -2), tau[..., None])[..., 0]

    def sensors(xi, xi_new, q, q_new):
        R_new = rot.quat_to_rot(rot.rpy_to_quat(xi_new[:, 0:3]))
        quat = rot.rpy_to_quat(xi_new[:, 0:3])
        a_w = (xi_new[:, 9:12] - xi[:, 9:12]) / dt
        return (quat, _mtv(R_new, a_w - g_vec), _mtv(R_new, xi_new[:, 6:9]),
                (q_new - q) / dt)

    def step(xi, q, foot_l, foot_r, cmd_q, cmd_tau, cmd_kp):
        R_wb = rot.quat_to_rot(rot.rpy_to_quat(xi[:, 0:3]))
        J_l = kin.contact_jacobian(gl, q[:, :3])
        J_r = kin.contact_jacobian(gr, q[:, 3:])
        feet = torch.stack([foot_l, foot_r], -2)
        Ac, Bc2 = srbd.linearize_shared(cfg.robot, feet, xi[:, 3:6],
                                        xi[:, 2])
        if cfg.mode == "stand":
            grf = torch.cat([_mv(R_wb, force(J_l, cmd_tau[:, :3])),
                             _mv(R_wb, force(J_r, cmd_tau[:, 3:]))], -1)
            Ad, Bd = srbd.discretize_srbd(
                Ac, torch.cat([Bc2[:, 0], Bc2[:, 1]], -1), dt)
            xi_new = _mv(Ad, xi) + _mv(Bd, grf)
            base_new = xi_new[:, 3:6]
            R_new = rot.quat_to_rot(rot.rpy_to_quat(xi_new[:, 0:3]))
            q_new = torch.cat([
                kin.inverse_kinematics_analytic(
                    gl, _mtv(R_new, foot_l - base_new), q[:, :3]),
                kin.inverse_kinematics_analytic(
                    gr, _mtv(R_new, foot_r - base_new), q[:, 3:])], -1)
            return (xi_new, q_new, foot_l, foot_r,
                    *sensors(xi, xi_new, q, q_new))
        # the swing side from the command's gain pattern (controller.tick
        # puts kp > 0 on the swing leg only in walk mode)
        left_swing = cmd_kp[:, 0] > 0.0
        ls = left_swing[:, None]
        tau_st = torch.where(ls, cmd_tau[:, 3:], cmd_tau[:, :3])
        J_st = torch.where(ls[..., None], J_r, J_l)
        f_w = _mv(R_wb, force(J_st, tau_st))
        zeros3 = torch.zeros_like(f_w)
        grf = torch.where(ls, torch.cat([zeros3, f_w], -1),
                          torch.cat([f_w, zeros3], -1))
        on_l = (1.0 - left_swing.to(dtype))[:, None, None]
        on_r = left_swing.to(dtype)[:, None, None]
        Ad, Bd = srbd.discretize_srbd(
            Ac, torch.cat([Bc2[:, 0] * on_l, Bc2[:, 1] * on_r], -1), dt)
        xi_new = _mv(Ad, xi) + _mv(Bd, grf)
        base_new = xi_new[:, 3:6]
        R_new = rot.quat_to_rot(rot.rpy_to_quat(xi_new[:, 0:3]))
        q_sw = torch.where(ls, cmd_q[:, :3], cmd_q[:, 3:])
        p_sw_w = base_new + _mv(R_new, kin.forward_kinematics(
            kin.select_geometry(left_swing, gl, gr), q_sw))
        # rigid ground
        p_sw_w = torch.cat([p_sw_w[:, :2], torch.clamp(
            p_sw_w[:, 2:], min=cfg.ground_height)], -1)
        foot_l_new = torch.where(ls, p_sw_w, foot_l)
        foot_r_new = torch.where(ls, foot_r, p_sw_w)
        q_st_l = kin.inverse_kinematics_analytic(
            gl, _mtv(R_new, foot_l_new - base_new), q[:, :3])
        q_st_r = kin.inverse_kinematics_analytic(
            gr, _mtv(R_new, foot_r_new - base_new), q[:, 3:])
        q_new = torch.where(ls, torch.cat([q_sw, q_st_r], -1),
                            torch.cat([q_st_l, q_sw], -1))
        return (xi_new, q_new, foot_l_new, foot_r_new,
                *sensors(xi, xi_new, q, q_new))

    return step


class WirePlant:
    """Plant thread speaking the pf_runtime wire protocol: waits for a
    command, steps the SRBD dynamics, publishes sensors. Republishes the
    latest sensor packet while idle so a dropped datagram cannot deadlock
    the lockstep loop. State tensors are [1, ...] on the CPU."""

    def __init__(self, cfg, state_port, cmd_port,
                 publish_truth_odom: bool = False):
        self.cfg = cfg
        self.host = rt.RobotHost(state_port=state_port, cmd_port=cmd_port)
        self.publish_truth_odom = publish_truth_odom
        self.step = make_plant_step(cfg)
        s0 = ro.initial_plant_state(cfg, batch=(1,), device="cpu")
        self.xi, self.q = s0.xi, s0.q
        self.foot_l, self.foot_r = s0.foot_l, s0.foot_r
        self.quat = np.asarray([0, 0, 0, 1], np.float32)
        self.acc = np.asarray([0, 0, 9.81], np.float32)
        self.gyro = np.zeros(3, np.float32)
        self.dq = np.zeros(6, np.float32)
        self.steps_taken = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _publish(self):
        self.host.publish_state(
            self.q[0].numpy(), dq=self.dq, quat=self.quat, acc=self.acc,
            gyro=self.gyro, stamp_ns=rt.now_ns())
        if self.publish_truth_odom:
            # the Gazebo ground-truth odometry feed of the reference
            # (include/state_estimator_fake.h:44-85) over the wire
            xi = self.xi[0].numpy()
            self.host.publish_odom(pos=xi[3:6], quat=self.quat,
                                   v_pos=xi[9:12], v_ori=xi[6:9],
                                   stamp_ns=rt.now_ns())

    def _loop(self):
        self._publish()
        last_pub = time.time()
        while not self._stop.is_set():
            cmd = self.host.poll_cmd()
            if cmd is None:
                if time.time() - last_pub > 0.01:
                    self._publish()
                    last_pub = time.time()
                time.sleep(0.0002)
                continue
            with torch.no_grad():
                out = self.step(self.xi, self.q, self.foot_l, self.foot_r,
                                *(torch.from_numpy(cmd[k])[None]
                                  for k in ("q", "tau", "kp")))
            (self.xi, self.q, self.foot_l, self.foot_r,
             quat, acc, gyro, dq) = out
            self.quat, self.acc = quat[0].numpy(), acc[0].numpy()
            self.gyro, self.dq = gyro[0].numpy(), dq[0].numpy()
            self.steps_taken += 1
            self._publish()
            last_pub = time.time()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.host.close()


def scripted_sensors(cfg: ControllerConfig, ticks: int, seed: int = 0):
    """A fixed, numpy-seeded sequence of `ticks` wire readings (state,
    IMU, truth odometry dicts, float32) around the nominal standing pose,
    walking forward at 0.5 m/s: the input of :class:`ScriptedLink`."""
    rng = np.random.default_rng(seed)
    s0 = ro.initial_plant_state(cfg, device="cpu")
    q0, base = s0.q.numpy(), s0.xi[3:6].numpy()
    f32 = np.float32
    out = []
    for t in range(ticks):
        quat = rot.rpy_to_quat(torch.tensor(
            rng.normal(0.0, 0.01, 3), dtype=torch.float32)).numpy()
        state = {"stamp_ns": t,
                 "q": (q0 + 0.005 * rng.standard_normal(6)).astype(f32),
                 "dq": (0.05 * rng.standard_normal(6)).astype(f32),
                 "tau": np.zeros(6, f32)}
        imu = {"stamp_ns": t, "quat": quat,
               "acc": (np.asarray([0.0, 0.0, 9.81])
                       + 0.2 * rng.standard_normal(3)).astype(f32),
               "gyro": (0.02 * rng.standard_normal(3)).astype(f32)}
        odom = {"stamp_ns": t,
                "pos": (base + np.asarray([0.5 * t * cfg.gait.dt, 0, 0])
                        + 1e-3 * rng.standard_normal(3)).astype(f32),
                "quat": quat,
                "v_pos": (np.asarray([0.5, 0.0, 0.0])
                          + 0.02 * rng.standard_normal(3)).astype(f32),
                "v_ori": (0.02 * rng.standard_normal(3)).astype(f32)}
        out.append((state, imu, odom))
    return out


class ScriptedLink:
    """An in-process stand-in for ``runtime.RobotLink``: each
    ``recv_state`` hands out the next reading of a fixed sequence (None
    once it is used up), ``recv_imu`` / ``recv_odom`` that tick's IMU and
    odometry; what the session sends is recorded in ``cmds`` and
    ``est``."""

    def __init__(self, sensors, with_odom: bool = True):
        self.sensors = sensors
        self.with_odom = with_odom
        self.i = 0
        self.cmds, self.est = [], []

    def recv_state(self):
        if self.i >= len(self.sensors):
            return None
        self.i += 1
        return dict(self.sensors[self.i - 1][0])

    def recv_imu(self):
        return dict(self.sensors[self.i - 1][1]) if self.i else None

    def recv_odom(self):
        if not (self.i and self.with_odom):
            return None
        return dict(self.sensors[self.i - 1][2])

    def recv_diag(self):
        return None

    def send_cmd(self, q, dq=None, tau=None, kp=None, kd=None, mode=None,
                 stamp_ns: int = 0):
        self.cmds.append({k: np.array(v, np.float32) for k, v in
                          (("q", q), ("dq", dq), ("tau", tau), ("kp", kp),
                           ("kd", kd))})

    def send_est_odom(self, pos, quat=(0, 0, 0, 1), v_pos=(0, 0, 0),
                      v_ori=(0, 0, 0), cov_diag=None, stamp_ns: int = 0):
        self.est.append({k: np.array(v, np.float32) for k, v in
                         (("pos", pos), ("quat", quat), ("v_pos", v_pos),
                          ("v_ori", v_ori), ("cov_diag", cov_diag))})

    def close(self):
        pass


# ---- the tests ------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _pf_runtime_built():
    """Build build/libpf_runtime.so once, under a lock: test workers that
    start together on a fresh checkout would otherwise write the same
    file while another loads it. (tests/test_torch_session.py and
    tests/test_torch_runtime.py import this fixture.)"""
    rt._BUILD.mkdir(exist_ok=True)
    with open(rt._BUILD / "pf_runtime.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield rt.build_library()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Session and plant tick at B = 1 on the CPU: host loops of small
    torch calls, which a multi-threaded BLAS only slows down beside other
    test workers (tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ports(base: int):
    p = base + 2 * (int(time.time() * 10) % 50)
    return p, p + 1


def _session(cfg, sp, cp):
    return ses.ControlSession(cfg, host_ip="127.0.0.1", state_port=sp,
                              cmd_port=cp, device="cpu")


def test_session_walks_with_kf():
    """KF walking over the UDP link (JAX test_session_walks_with_kf, 1500
    ticks): height held, upright, forward progress, the filter on the
    truth, the covariance stream published."""
    sp, cp = _ports(19600)
    cfg = ControllerConfig.walking()
    plant = WirePlant(cfg, sp, cp)
    try:
        with _session(cfg, sp, cp) as session:
            # seed the filter at the known start pose
            x = session.kf.x_hat
            x[0:3] = plant.xi[0, 3:6]
            x[6:9] = plant.foot_l[0]
            x[9:12] = plant.foot_r[0]
            session.kf = session.kf.replace(x_hat=x)
            iters = 1500
            stats = session.run(iterations=iters, hz=1000.0, use_kf=True,
                                est_odom_every=5)
        assert stats["sent"] == iters
        xi = plant.xi[0].numpy()
        assert plant.steps_taken > iters * 0.9
        assert 0.55 < xi[5] < 0.75, xi[5]
        assert abs(xi[0]) < 0.2 and abs(xi[1]) < 0.2, xi[0:2]
        assert xi[3] > 0.1, xi[3]
        est = session.kf.x_hat[0:3].numpy()
        assert np.linalg.norm(est - xi[3:6]) < 0.1
        assert stats["est_odom_published"] >= iters // 10
        got = plant.host.poll_est_odom()
        assert got is not None and np.isfinite(got["cov_diag"]).all()
    finally:
        plant.close()


def test_session_production_path_truth_odom():
    """The warm dtMPC production path with truth odometry over the wire
    (JAX test_session_production_path_truth_odom, 1500 ticks): one solve
    every 5 ticks, the latency statistics, the sim quality bands, and the
    end state within the JAX test's envelope of the port's own rollout of
    the same config and schedule."""
    sp, cp = _ports(19700)
    cfg = ControllerConfig.walking()
    plant = WirePlant(cfg, sp, cp, publish_truth_odom=True)
    try:
        with _session(cfg, sp, cp) as session:
            iters = 1500
            stats = session.run(iterations=iters, hz=1000.0)
        assert stats["sent"] == iters
        assert stats["mpc_solves"] == iters // cfg.gait.mpc_step
        assert stats["mpc_holds"] == iters - stats["mpc_solves"]
        assert stats["tick_latency_p50"] > 0.0
        assert stats["solve_latency_p50"] > 0.0
        assert stats["hold_latency_p50"] > 0.0
        assert stats["tick_latency_max"] >= stats["tick_latency_p95"] \
            >= stats["tick_latency_p50"]
        xi = plant.xi[0].numpy()
        assert plant.steps_taken > iters * 0.9
        assert 0.63 < xi[5] < 0.67, xi[5]
        assert abs(xi[0]) < 0.1 and abs(xi[1]) < 0.1, xi[0:2]
        assert xi[3] > 0.2, xi[3]
        sim_final, _ = ro.rollout(cfg, ro.initial_plant_state(
            cfg, device="cpu"), iters, mpc_every=cfg.gait.mpc_step)
        sim_xi = sim_final.xi.numpy()
        assert abs(xi[5] - sim_xi[5]) < 0.03, (xi[5], sim_xi[5])
        assert abs(xi[3] - sim_xi[3]) < 0.25 * max(1.0, sim_xi[3]), \
            (xi[3], sim_xi[3])
    finally:
        plant.close()


def test_session_async_dispatch_walks():
    """async_dispatch (JAX test_session_async_dispatch_walks, 1500
    ticks): every tick holds the newest completed solve's force; the
    staleness histogram is measured and the robot walks as well as on
    the synchronous path."""
    sp, cp = _ports(19800)
    cfg = ControllerConfig.walking()
    plant = WirePlant(cfg, sp, cp, publish_truth_odom=True)
    try:
        with _session(cfg, sp, cp) as session:
            iters = 1500
            stats = session.run(iterations=iters, hz=1000.0,
                                async_dispatch=True)
        assert stats["sent"] == iters
        assert stats["solves_dispatched"] >= iters // cfg.gait.mpc_step
        assert stats["solves_adopted"] >= 1
        assert stats["grf_staleness_p50"] >= 0.0
        assert stats["grf_staleness_max"] >= stats["grf_staleness_p50"]
        xi = plant.xi[0].numpy()
        assert plant.steps_taken > iters * 0.9
        assert 0.63 < xi[5] < 0.67, xi[5]
        assert abs(xi[0]) < 0.1 and abs(xi[1]) < 0.1, xi[0:2]
        assert xi[3] > 0.2, xi[3]
    finally:
        plant.close()


def test_session_standing_balance():
    """Standing balance through the live session (JAX
    test_session_standing_balance, 1000 ticks): the two-foot warm QP on
    the dtMPC schedule holds the height with both feet pinned."""
    sp, cp = _ports(19900)
    cfg = ControllerConfig.standing()
    plant = WirePlant(cfg, sp, cp, publish_truth_odom=True)
    try:
        with _session(cfg, sp, cp) as session:
            iters = 1000
            stats = session.run(iterations=iters, hz=1000.0)
        assert stats["sent"] == iters
        assert stats["mpc_solves"] == iters // cfg.gait.mpc_step
        xi = plant.xi[0].numpy()
        assert plant.steps_taken > iters * 0.9
        assert 0.63 < xi[5] < 0.67, xi[5]
        assert abs(xi[3]) < 0.05 and abs(xi[4]) < 0.05, xi[3:5]
        assert abs(xi[0]) < 0.05 and abs(xi[1]) < 0.05, xi[0:2]
    finally:
        plant.close()
