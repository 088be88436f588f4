"""The port's control session over the native UDP loopback, on CPU tensors,
and against the JAX session on the same sensor sequence.

Counterparts of the 11 tests of tests/test_session.py (move-to-zero,
group / single joint moves, the MPC loop with truth and KF odometry,
odometry over the wire, the helpers, the safety commands, the calibration
gate, the published KF odometry), on ports 19100-19599; and a parity
test that needs no UDP: an in-process link replays one numpy-seeded
sensor sequence to the JAX ``ControlSession.run`` and to the port's, and
every command they send is compared tick for tick.
"""

import dataclasses
import math
import threading
import time

import numpy as np
import pytest
import torch

from mpc_limx_control_tpu_torch import runtime as rt
from mpc_limx_control_tpu_torch.control import session as ses
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.core.types import OdomState
from mpc_limx_control_tpu_torch.utils import rotations as rot

from test_torch_session_walking import (  # noqa: F401  (a fixture)
    ScriptedLink, _pf_runtime_built, scripted_sensors)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Session ticks at B = 1 on the CPU: one torch thread per test worker
    (tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class LoopbackRobot:
    """Ideal position-servo robot: q tracks commanded q instantly."""

    def __init__(self, state_port, cmd_port, q0=None, hz=2000.0):
        self.host = rt.RobotHost(state_port=state_port, cmd_port=cmd_port)
        self.q = np.zeros(6, np.float32) if q0 is None else np.asarray(
            q0, np.float32)
        self.hz = hz
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        rate = rt.Rate(self.hz)
        try:
            while not self._stop.is_set():
                cmd = self.host.poll_cmd()
                if cmd is not None:
                    track = cmd["kp"] > 0
                    self.q[track] = cmd["q"][track]
                self.host.publish_state(
                    self.q, quat=(0, 0, 0, 1), acc=(0, 0, 9.81))
                rate.sleep()
        finally:
            rate.close()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.host.close()


@pytest.fixture
def robot_ports():
    base = 19100 + 2 * (int(time.time() * 10) % 200)
    return base, base + 1


def _session(sp, cp, cfg=None):
    return ses.ControlSession(cfg, host_ip="127.0.0.1", state_port=sp,
                              cmd_port=cp, device="cpu")


def test_move_group_joints_reaches_zero(robot_ports):
    sp, cp = robot_ports
    robot = LoopbackRobot(sp, cp, q0=[0.4, -0.3, 0.5, -0.2, 0.3, -0.4])
    try:
        with rt.RobotLink("127.0.0.1", sp, cp) as link:
            ok = ses.move_group_joints(link, np.zeros(6), duration_iters=200,
                                       hz=500.0, max_iters=3000)
        assert ok
        np.testing.assert_allclose(robot.q, 0.0, atol=0.1)
    finally:
        robot.close()


def test_move_single_joint(robot_ports):
    sp, cp = robot_ports
    robot = LoopbackRobot(sp, cp)
    try:
        with rt.RobotLink("127.0.0.1", sp, cp) as link:
            ok = ses.move_single_joint(link, 2, 0.7, duration_iters=200,
                                       hz=500.0, max_iters=3000)
        assert ok
        assert abs(robot.q[2] - 0.7) < 0.1
    finally:
        robot.close()


def test_session_mpc_loop(robot_ports):
    sp, cp = robot_ports
    robot = LoopbackRobot(sp, cp)
    try:
        with _session(sp, cp) as session:
            session.init()
            assert session.start(timeout_iters=2000)
            stats = session.run(iterations=30, hz=200.0)
        assert stats["sent"] == 30
    finally:
        robot.close()


def test_session_kf_loop(robot_ports):
    """The use_kf path: KF-estimated odometry drives the tick."""
    sp, cp = robot_ports
    robot = LoopbackRobot(sp, cp)
    try:
        with _session(sp, cp) as session:
            stats = session.run(iterations=15, hz=100.0, use_kf=True)
        assert stats["sent"] == 15
        # the filter state advanced
        assert float(session.kf.x_hat.abs().max()) > 0.0
    finally:
        robot.close()


def test_odometry_over_the_wire(robot_ports):
    sp, cp = robot_ports
    robot = LoopbackRobot(sp, cp)
    try:
        with rt.RobotLink("127.0.0.1", sp, cp) as link:
            deadline = time.time() + 2.0
            got = None
            while got is None and time.time() < deadline:
                robot.host.publish_odom(
                    pos=(0.1, 0.2, 0.65), v_pos=(0.5, 0, 0), stamp_ns=5)
                time.sleep(0.002)
                got = link.recv_odom()
        assert got is not None
        np.testing.assert_allclose(got["pos"], [0.1, 0.2, 0.65], atol=1e-7)
        np.testing.assert_allclose(got["v_pos"], [0.5, 0, 0], atol=1e-7)
    finally:
        robot.close()


def test_error_test_semantics():
    assert ses.error_test([0] * 6, [0.05] * 6, 0.1)
    assert not ses.error_test([0] * 6, [0.05, 0.2, 0, 0, 0, 0], 0.1)


def test_square_wave_torque():
    t0 = ses.square_wave_torque(0)
    t1 = ses.square_wave_torque(1000)
    np.testing.assert_allclose(t0[[0, 3]], 20.0)
    np.testing.assert_allclose(t1[[0, 3]], -20.0)
    assert (t0[[1, 2, 4, 5]] == 0).all()


def test_zero_torque_and_damping(robot_ports):
    """The PFControllerBase safety commands
    (src/pf_controller_base.cpp:72-97): zeroTorque sends all-zero
    gains/targets; damping sends kd = 4 only."""
    sp, cp = robot_ports
    with rt.RobotHost(state_port=sp, cmd_port=cp) as host, \
            _session(sp, cp) as session:
        deadline = time.time() + 2.0
        got = None
        while got is None and time.time() < deadline:
            session.zero_torque()
            time.sleep(0.002)
            got = host.poll_cmd()
        assert got is not None
        for k in ("q", "dq", "tau", "kp", "kd"):
            np.testing.assert_allclose(got[k], 0.0, atol=1e-7)

        got = None
        deadline = time.time() + 2.0
        while got is None and time.time() < deadline:
            session.damping()
            time.sleep(0.002)
            c = host.poll_cmd()
            if c is not None and c["kd"][0] == 4.0:
                got = c
        assert got is not None
        np.testing.assert_allclose(got["kd"], 4.0, atol=1e-7)
        for k in ("q", "dq", "tau", "kp"):
            np.testing.assert_allclose(got[k], 0.0, atol=1e-7)


def test_calibration_gate_aborts(robot_ports):
    """A calibration diagnostic with nonzero code trips init()."""
    sp, cp = robot_ports
    with rt.RobotHost(state_port=sp, cmd_port=cp) as host, \
            _session(sp, cp) as session:
        stop = threading.Event()

        def spam():
            while not stop.is_set():
                host.publish_diag(rt.DIAG_CALIBRATION, code=1, level=2)
                time.sleep(0.002)

        t = threading.Thread(target=spam, daemon=True)
        t.start()
        try:
            with pytest.raises(ses.CalibrationError):
                session.init(settle_s=1.0)
            assert not session.calibrated
        finally:
            stop.set()
            t.join(timeout=2.0)


def test_calibration_gate_passes(robot_ports):
    sp, cp = robot_ports
    with rt.RobotHost(state_port=sp, cmd_port=cp) as host, \
            _session(sp, cp) as session:
        host.publish_diag(rt.DIAG_CALIBRATION, code=0)
        time.sleep(0.05)
        session.init(settle_s=0.1)   # must not raise
        assert session.calibrated


def test_session_kf_publishes_est_odom(robot_ports):
    """run(use_kf=True) publishes KF odometry + covariance back over the
    wire."""
    sp, cp = robot_ports
    robot = LoopbackRobot(sp, cp)
    try:
        with _session(sp, cp) as session:
            stats = session.run(iterations=12, hz=100.0, use_kf=True,
                                est_odom_every=2)
        assert stats["est_odom_published"] >= 5
        time.sleep(0.05)
        got = robot.host.poll_est_odom()
        assert got is not None
        assert np.isfinite(got["cov_diag"]).all()
        assert (got["cov_diag"] >= 0).all()
    finally:
        robot.close()


# ---- the port's session against the JAX session ----------------------------

COUNTERS = ("sent", "stale", "est_odom_published", "mpc_solves", "mpc_holds",
            "solves_dispatched", "solves_adopted")
# float32 bands of a sent command, port against JAX: q as
# tests/test_torch_slice.py::test_rollout_20_ticks_matches_jax_f32 holds it
# (measured <= 2.2e-6); tau (N m, on a ~28 N m scale) from the stance
# force, where the two libraries' f32 K^-1 ADMM rounds differently:
# measured <= 9.9e-5 over the three runs, the band ~7x that; dq, kp and kd
# are configuration values, equal.
CMD_BANDS = {"q": 1e-5, "dq": 0.0, "tau": 7e-4, "kp": 0.0, "kd": 0.0}
# the published KF odometry: measured <= 4.8e-7; the covariance diagonal
# after the first update from 100 I, the float32 cancellation of
# tests/test_torch_kf.py: measured 3.1e-5, the band ~7x that
EST_BANDS = {"pos": 1e-5, "quat": 1e-5, "v_pos": 1e-5, "v_ori": 1e-5,
             "cov_diag": 2e-4}


def _run_scripted(session, sensors, use_kf):
    session.link.close()
    session.link = ScriptedLink(sensors)
    stats = session.run(iterations=len(sensors), hz=1000.0, use_kf=use_kf,
                        est_odom_every=5)
    return session.link, stats


@pytest.mark.parametrize("case", ["walk_truth", "walk_kf", "stand"])
def test_session_matches_jax_session(case, robot_ports):
    """The JAX ControlSession.run and the port's on one scripted sensor
    sequence of 30 ticks (no UDP): six solve / hold cycles of the dtMPC
    schedule, the anchor seeded at tick 0, with the KF the filter and the
    odometry published every 5 ticks. Every command tick for tick within
    CMD_BANDS, the published odometry within EST_BANDS, the statistics'
    counters equal."""
    from mpc_limx_control_tpu.control import session as jses
    from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg

    mode = "stand" if case == "stand" else "walk"
    use_kf = case == "walk_kf"
    tcfg = TCfg.standing() if mode == "stand" else TCfg.walking()
    jcfg = JCfg.standing() if mode == "stand" else JCfg.walking()
    sensors = scripted_sensors(tcfg, 30, seed=11)
    sp, cp = robot_ports
    with jses.ControlSession(jcfg, "127.0.0.1", sp, cp) as js:
        jlink, jstats = _run_scripted(js, sensors, use_kf)
    with _session(sp, cp, tcfg) as ts:
        tlink, tstats = _run_scripted(ts, sensors, use_kf)
    assert len(tlink.cmds) == len(jlink.cmds) == 30
    gaps = {k: 0.0 for k in CMD_BANDS}
    for ct, cj in zip(tlink.cmds, jlink.cmds):
        for k, band in CMD_BANDS.items():
            gaps[k] = max(gaps[k], float(np.abs(ct[k] - cj[k]).max()))
    for k, band in CMD_BANDS.items():
        assert gaps[k] <= band, (k, gaps[k])
    assert len(tlink.est) == len(jlink.est) == (6 if use_kf else 0)
    for et, ej in zip(tlink.est, jlink.est):
        for k, band in EST_BANDS.items():
            np.testing.assert_allclose(et[k], ej[k], atol=band, rtol=0,
                                       err_msg=k)
    assert {k: tstats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}
    assert tstats["mpc_solves"] == 6
    if mode == "walk":
        np.testing.assert_allclose(ts.ref_anchor.numpy(),
                                   np.asarray(js.ref_anchor), atol=1e-5)
    if use_kf:
        np.testing.assert_allclose(ts.kf.x_hat.numpy(),
                                   np.asarray(js.kf.x_hat), atol=1e-5)
    z_t, y_t = ts.qp_state
    np.testing.assert_allclose(z_t.numpy(), np.asarray(js.qp_state[0]),
                               atol=0.1, rtol=0)


def test_session_initial_state_matches_jax(robot_ports):
    """The cold warm-start state (y = 0 for ADMM, as JAX's session starts
    it, unlike the rollout's Riccati ones: ROADMAP, "Not faults"), the
    filter's initial state and the anchor before the first tick."""
    from mpc_limx_control_tpu.control import session as jses
    from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg

    sp, cp = robot_ports
    for jcfg, tcfg in ((JCfg.walking(), TCfg.walking()),
                       (JCfg.standing(), TCfg.standing())):
        with jses.ControlSession(jcfg, "127.0.0.1", sp, cp) as js, \
                _session(sp + 2, cp + 2, tcfg) as ts:
            for a, b in zip(ts.qp_state, js.qp_state):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(ts.kf.p_cov.numpy(),
                                          np.asarray(js.kf.p_cov))
            assert (ts.ref_anchor is None) == (js.ref_anchor is None)
    pdip = dataclasses.replace(tcfg, srbd=dataclasses.replace(
        tcfg.srbd, solver=dataclasses.replace(tcfg.srbd.solver,
                                              method="pdip")))
    with _session(sp, cp, pdip) as ts:
        assert float(ts.qp_state[1].min()) == 1.0
    with pytest.raises(ValueError, match="warm"):
        with _session(sp, cp, TCfg()) as ts:
            ts.run(1, async_dispatch=True)


def _variant(name):
    """The walking tuning changed in one respect (or standing)."""
    from mpc_limx_control_tpu_torch.core.config import SolverConfig

    cfg = TCfg.walking()
    srbd, solver = cfg.srbd, cfg.srbd.solver
    changes = {
        "walk": {},
        "walk_kf": {"estimator_mode": "kf"},
        "walk_inv": {"srbd": dataclasses.replace(srbd, solver=dataclasses
                                                 .replace(solver,
                                                          solve_form="inv"))},
        "walk_reference_placement": {"placement_mode": "reference"},
        "stand": None,
        "pdip": {"srbd": dataclasses.replace(srbd, solver=SolverConfig(
            method="pdip"))},
        "riccati": {"srbd": dataclasses.replace(srbd, solver=dataclasses
                                                .replace(solver,
                                                         method="riccati"))},
        "cold": {"qp_warm_start": False},
        "damped_ls": {"ik_method": "damped_ls"},
        "log6": {"ik_method": "log6"},
        "receding": {"srbd": dataclasses.replace(srbd,
                                                 attitude_ref="receding")},
        "horizon_86": {"srbd": dataclasses.replace(srbd, horizon=86)},
    }[name]
    return TCfg.standing() if changes is None else \
        dataclasses.replace(cfg, **changes)


KERNEL_SESSIONS = ("walk", "walk_kf", "walk_inv", "walk_reference_placement")


@pytest.mark.parametrize("name", KERNEL_SESSIONS + (
    "stand", "pdip", "riccati", "cold", "damped_ls", "log6", "receding",
    "horizon_86"))
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_session_kernel_gate(name, device):
    """Which sessions run their solve and held-force ticks as the
    walking_session_tick kernels, decided from the config and the device
    alone (no card needed): walking admm_fused with the analytic IK and a
    level reference on a CUDA device; standing, PDIP, Riccati, cold
    starts, the iterative IKs, the receding reference, a horizon past the
    tick kernels' and every CPU session keep the plain functions."""
    from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc

    cfg = _variant(name)
    want = device == "cuda" and name in KERNEL_SESSIONS
    assert ses._kernel_ticks(cfg, torch.device(device)) is want
    assert ses._kernel_ticks(cfg, device) is want
    # walking sessions take the kernels exactly where the tick kernels
    # implement the config
    if cfg.mode == "walk":
        assert (tfc.kernel_refusal(cfg) is None) is (name in KERNEL_SESSIONS)
    if want:
        p = tfc.session_params(cfg)
        assert p.tick.mpc.N == cfg.srbd.horizon
        assert (p.kp, p.kd) == (cfg.kp, cfg.kd)
        assert list(p.vdes) == list(cfg.desired_velocity)
        assert p.anchor == int(cfg.ref_anchor_band > 0.0)
        assert p.inv == int(name == "walk_inv")


def test_cpu_session_reports_no_kernel_ticks():
    """A CPU session keeps the plain tick functions, and run() counts no
    tick of the session kernels."""
    cfg = TCfg.walking()
    with ses.ControlSession(cfg, state_port=19580, cmd_port=19581,
                            device="cpu") as s:
        assert not s._kernel
        assert s._fns["warm"] == s._warm_fn and s._fns["hold"] == s._hold_fn
        link, stats = _run_scripted(s, scripted_sensors(cfg, 7, seed=2),
                                    False)
    assert stats["sent"] == 7 and stats["kernel_ticks"] == 0


def test_session_kernel_reads_the_session_packet_layout():
    """csrc/session_tick.cu reads the session's packet and writes its
    outputs at the offsets control/session.py lays them out at."""
    import re
    from pathlib import Path

    from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc

    src = (Path(tfc.__file__).parent / "csrc" / "session_tick.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert {k: const[k] for k in ("PK_Q", "PK_POS", "PK_ORI", "PK_QUAT",
                                  "PK_VPOS", "PK_VORI", "PK_IT",
                                  "PK_ANCHOR", "PK_GRF")} == {
        "PK_Q": ses.Q.start, "PK_POS": ses.POS.start,
        "PK_ORI": ses.ORI.start, "PK_QUAT": ses.OQUAT.start,
        "PK_VPOS": ses.VPOS.start, "PK_VORI": ses.VORI.start,
        "PK_IT": ses.IT.start, "PK_ANCHOR": ses.ANCHOR.start,
        "PK_GRF": ses.GRF.start}
    assert (const["PK_SOLVE_IN"], const["PK_PACKET"], const["OUT_CMD"],
            const["OUT_ANCHOR"], const["OUT_GRF"], const["OUT_WARM"]) == (
        ses.SOLVE_IN, ses.PACKET, ses.CMD, ses.W_ANCHOR.start,
        ses.W_GRF.start, ses.W_GRF.stop)
    assert (tfc.SESSION_PACKET, tfc.SESSION_SOLVE_IN, tfc.SESSION_CMD,
            tfc.SESSION_WARM_OUT) == (ses.PACKET, ses.SOLVE_IN, ses.CMD,
                                      ses.W_GRF.stop)


def test_ptxas_resources_reads_each_kernels_line():
    """_build.ptxas_resources keys each kernel's resource line by its source
    and name (the card's session-kernel check compares the batched entry
    points' lines with the parent's build through it)."""
    from mpc_limx_control_tpu_torch.ops import _build

    log = """--- walking_tick.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__455d510a_3fooPf' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__455d510a_3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 408 bytes cmem[0]
--- session_tick.cu
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 384 bytes cmem[0]
"""
    res = _build.ptxas_resources(log)
    assert res == {
        ("walking_tick.cu", "_ZN48_GLOBAL__N__3fooPf"):
            "Used 80 registers, used 1 barriers, 408 bytes cmem[0]; "
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        ("session_tick.cu", "_Z3barv"):
            "Used 40 registers, 384 bytes cmem[0]; "
            "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"}


@pytest.mark.parametrize("case", ["cpu_tensors", "stand"])
def test_session_kernel_wrappers_refuse_what_they_do_not_run(case):
    """The session kernels' wrappers raise, before any launch, for CPU
    tensors and for a config the session keeps on the plain functions."""
    from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc

    cfg = TCfg.walking() if case == "cpu_tensors" else TCfg.standing()
    n = 3 * cfg.srbd.horizon
    with pytest.raises(ValueError, match="session kernels"):
        tfc.walking_session_tick(cfg, torch.zeros(1, ses.SOLVE_IN),
                                 torch.zeros(1, n), torch.zeros(1, 2 * n),
                                 torch.zeros(1, ses.W_GRF.stop))
    with pytest.raises(ValueError, match="session kernels"):
        tfc.walking_session_tick_hold(cfg, torch.zeros(1, ses.PACKET),
                                      torch.zeros(1, ses.CMD))


# ---- the host fill of the truth odometry ------------------------------------

def _wrapped_gap(a, b):
    """|a - b| of angles, 2 pi apart counted equal; NaN where both are."""
    d = np.abs((np.asarray(a) - np.asarray(b) + np.pi) % (2 * np.pi) - np.pi)
    both = np.isnan(a) & np.isnan(b)
    return np.where(both, 0.0, d)


def _quats(case):
    """[n, 4] float32 quaternions (x, y, z, w) of one case."""
    rng = np.random.default_rng(21)
    n = 4096
    if case == "identity":
        return np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    if case == "clamp":
        # pitch within 4e-3 rad of +90 deg: -2 (xz - wy) = sin(pitch) >=
        # cos(4e-3) > 0.99999
        rpy = np.stack([rng.uniform(-np.pi, np.pi, n),
                        np.pi / 2 - rng.uniform(0.0, 4e-3, n),
                        rng.uniform(-np.pi, np.pi, n)], -1)
        return rot.rpy_to_quat(torch.from_numpy(rpy)).numpy().astype(
            np.float32)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if case == "non_unit":
        # norms 0.5-1.5: -2 (xz - wy) runs past both ends of [-1, 1]
        q *= rng.uniform(0.5, 1.5, (n, 1))
    return q.astype(np.float32)


@pytest.mark.parametrize("case, dtype", [
    ("random_unit", "float32"), ("random_unit", "float64"),
    ("non_unit", "float32"), ("non_unit", "float64"), ("clamp", "float64"),
    ("identity", "float32"), ("identity", "float64")])
def test_quat_to_rpy_host_matches_quat_to_rpy(case, dtype):
    """rotations.quat_to_rpy_host (Python floats) against quat_to_rpy on
    the same float32 quaternions: within 1e-9 rad in float64 (the clamp at
    0.99999 and torch.asin's NaN below -1 included), within 1e-6 rad in
    float32. Float32 resolves roll and yaw only away from gimbal lock
    (its error grows as 1 / cos(pitch): 6.6e-6 rad where sin(pitch) >
    0.9999), so the float32 comparison takes |sin(pitch)| <= 0.99, and the
    clamp case (sin(pitch) > 0.99999) is held in float64 alone."""
    q = _quats(case)
    host = np.array([rot.quat_to_rpy_host(*map(float, r)) for r in q])
    ref = rot.quat_to_rpy(torch.from_numpy(q).to(getattr(torch, dtype))) \
        .double().numpy()
    x, y, z, w = q.astype(np.float64).T
    sin_pitch = -2.0 * (x * z - w * y)
    if dtype == "float32":
        keep, band = np.abs(sin_pitch) <= 0.99, 1e-6
    else:
        keep, band = np.ones(len(q), bool), 1e-9
    assert keep.mean() > 0.8
    np.testing.assert_array_equal(np.isnan(host[keep]), np.isnan(ref[keep]))
    assert _wrapped_gap(host[keep], ref[keep]).max() <= band
    if case == "clamp":
        assert (host[:, 1] == math.asin(0.99999)).all()
    if case == "non_unit":
        assert (sin_pitch > 0.99999).any() and np.isnan(host[:, 1]).any()
    if case == "identity":
        assert host.tolist() == [[0.0, 0.0, 0.0]]


def _truth_ticks(cfg):
    """Four truth-path ticks: no odometry yet, a fresh odometry, none (the
    last kept), another fresh one; orientations up to 0.6 rad."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    ticks = []
    for t, fresh in enumerate((False, True, False, True)):
        state = {k: rng.normal(size=6).astype(f32) for k in ("q", "dq", "tau")}
        odom = None
        if fresh:
            quat = rot.rpy_to_quat(torch.from_numpy(
                rng.uniform(-0.6, 0.6, 3))).numpy().astype(f32)
            odom = {"stamp_ns": t, "pos": rng.normal(size=3).astype(f32),
                    "quat": quat, "v_pos": rng.normal(size=3).astype(f32),
                    "v_ori": rng.normal(size=3).astype(f32)}
        ticks.append((state, odom))
    return ticks


def _old_fill(cfg, it, state, odom_raw, last):
    """The truth path's sensor floats as _fill_sensors wrote them with
    torch on the host: roll, pitch and yaw through the float32
    quat_to_rpy, the odometry concatenated and kept, the nominal standing
    pose rebuilt each tick until the first. Returns (sensors, last)."""
    if odom_raw is not None:
        quat = np.asarray(odom_raw["quat"], np.float32)
        ori = rot.quat_to_rpy(torch.from_numpy(quat)).numpy()
        last = np.concatenate([odom_raw["pos"], ori, quat, odom_raw["v_pos"],
                               odom_raw["v_ori"]]).astype(np.float32)
    if last is not None:
        odom = last
    else:
        o = OdomState.zeros((1,), device="cpu").replace(
            pos=torch.tensor([[0.0, 0.0, cfg.base_height]]))
        odom = torch.cat([o.pos, o.ori, o.quat, o.v_pos, o.v_ori],
                         -1)[0].numpy()
    s = np.zeros(ses.SENSORS, np.float32)
    s[ses.Q], s[ses.DQ], s[ses.TAU] = state["q"], state["dq"], state["tau"]
    s[ses.ODOM] = odom
    s[ses.IT] = float(it)
    return s, last


def test_fill_sensors_writes_the_packet_the_old_fill_wrote():
    """A truth-path sequence through _fill_sensors (before any odometry,
    a fresh one, none, a fresh one): the packet's 47 sensor floats on the
    device are the ones the torch fill wrote, within 1e-6."""
    cfg = TCfg.walking()
    with ses.ControlSession(cfg, state_port=19582, cmd_port=19583,
                            device="cpu") as s:
        last = None
        for it, (state, odom) in enumerate(_truth_ticks(cfg)):
            s._fill_sensors(it, state, None, odom, use_kf=False)
            want, last = _old_fill(cfg, it, state, odom, last)
            got = s._packet[0, :ses.SENSORS].numpy()
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f"tick {it}")
        assert float(s._packet[0, ses.ORI].abs().max()) > 0.1


def test_truth_fill_dispatches_one_op_the_copy():
    """Every truth-path _fill_sensors (before any odometry, with one,
    without) makes one torch call: the copy of the pinned sensors into
    the device packet."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    cfg = TCfg.walking()
    with ses.ControlSession(cfg, state_port=19582, cmd_port=19583,
                            device="cpu") as s:
        for it, (state, odom) in enumerate(_truth_ticks(cfg)):
            with Ops() as m:
                s._fill_sensors(it, state, None, odom, use_kf=False)
            assert m.ops == [torch.ops.aten.copy_.default], (it, m.ops)
