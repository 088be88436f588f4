"""Host-side robot control session: the application layer.

Counterpart of ``mpc_limx_control_tpu.control.session`` (the reference's
entry-point executables, SURVEY.md §2, L5):

* :class:`ControlSession` = the `MPCWalking` app
  (src/mpc_control_fake_state.cpp:18-157): owns a runtime link, runs
  `init` (calibration gate), `start` (move-to-zero with linear
  interpolation and the errorTest tolerance gate,
  src/mpc_control_fake_state.cpp:48-102) and `run` (the 1 kHz loop: poll
  state -> controller tick -> publish command), ticking at the configured
  rate;
* :func:`move_single_joint` / :func:`move_group_joints` = the limX SDK
  demos pf_joint_move / pf_groupJoints_move (src/pf_joint_move.cpp:36-78,
  src/pf_groupJoints_move.cpp:39-89);
* :func:`square_wave_torque` = the actuator smoke test of
  src/MPCController.cpp:8-17;
* :func:`error_test` = MPCParam::errorTest (include/MPCParam.h:75-82).

The JAX session's three ``jax.jit`` closures (the warm solve tick, the
held-force tick, the estimator tick; and the cold tick of a config
without warm start) are plain functions here. They read and write a few
static tensors at batch 1: one packet of the tick's inputs (joints,
odometry, IMU, contacts, iteration, the reference anchor and the held
force), the QP warm state (z, y) and the filter state. On the card each
function is captured once as a CUDA graph when the session is made, and a
tick is one host-to-device copy of the sensors from a pinned buffer, the
graph replays, and one device-to-host copy of the packed 30-float command
[q dq tau kp kd] into a pinned buffer. A capture that fails raises.
``cuda_graphs=False`` runs the functions eagerly on the card instead (the
same kernels, launched one by one), and CPU tensors (``device="cpu"``)
always run them eagerly.

On the card a walking session whose config the tick kernels implement
(``tick_fused_cuda.kernel_refusal`` None) runs its solve and held-force
ticks as one kernel launch each (``walking_session_tick`` /
``walking_session_tick_hold``, csrc/session_tick.cu) instead of the plain
``controller.tick``: the counterpart of XLA's fusion of the JAX session's
closures. Its graphs are then the kernel between their two timing events.
Standing sessions, CPU sessions and the configs the tick kernels refuse
keep the plain functions.

Every tick of ``run`` is logged in the session's ``tick_log``
(``utils/profiling.TickLog``): the stamps of its phases, its kind, and the
device time of each graph it replayed, timed by two events recorded
inside the graph's capture (its first node to its last).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from mpc_limx_control_tpu_torch import runtime as rt
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import (ImuData, JointState,
                                                   KFState, OdomState,
                                                   default_device)
from mpc_limx_control_tpu_torch.control import controller as ctrl
from mpc_limx_control_tpu_torch.control import estimator as est
from mpc_limx_control_tpu_torch.control import gait as gaitmod
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc
from mpc_limx_control_tpu_torch.utils import profiling as prof
from mpc_limx_control_tpu_torch.utils import rotations as rotu


def error_test(target_pos, now_pos, tolerance: float = 0.1) -> bool:
    """All six joints within tolerance (include/MPCParam.h:75-82)."""
    t = np.asarray(target_pos, np.float64)
    n = np.asarray(now_pos, np.float64)
    return bool((np.abs(t[:6] - n[:6]) < tolerance).all())


def square_wave_torque(iteration: int, amplitude: float = 20.0,
                       period: int = 1000) -> np.ndarray:
    """+/-amplitude Nm on joints 1 and 4 (0-indexed: 0 and 3), switching
    every `period` iterations (src/MPCController.cpp:8-17)."""
    tau = np.zeros(6, np.float32)
    sign = 1.0 if (iteration // period) % 2 == 0 else -1.0
    tau[0] = sign * amplitude
    tau[3] = sign * amplitude
    return tau


def move_single_joint(link: rt.RobotLink, joint_id: int, target: float,
                      kp: float = 60.0, kd: float = 3.0,
                      duration_iters: int = 2000, hz: float = 1000.0,
                      max_iters: int = 20000) -> bool:
    """pf_joint_move: interpolate one joint to `target` at 1 kHz."""
    with rt.Rate(hz) as rate:
        init_q = None
        for it in range(max_iters):
            state = link.recv_state()
            if state is None:
                rate.sleep()
                continue
            if init_q is None:
                init_q = state["q"].copy()
            r = min(max(it / duration_iters, 0.0), 1.0)
            q_cmd = state["q"].copy()
            q_cmd[joint_id] = (1 - r) * init_q[joint_id] + r * target
            kp_v = np.zeros(6, np.float32)
            kd_v = np.zeros(6, np.float32)
            kp_v[joint_id] = kp
            kd_v[joint_id] = kd
            link.send_cmd(q=q_cmd, kp=kp_v, kd=kd_v)
            if r >= 1.0 and abs(state["q"][joint_id] - target) < 0.1:
                return True
            rate.sleep()
    return False


def move_group_joints(link: rt.RobotLink, targets, kp: float = 60.0,
                      kd: float = 3.0, duration_iters: int = 2000,
                      hz: float = 1000.0, tolerance: float = 0.1,
                      max_iters: int = 20000) -> bool:
    """pf_groupJoints_move / the session's move-to-zero phase: linear
    interpolation of all joints with the errorTest gate."""
    targets = np.asarray(targets, np.float32)
    with rt.Rate(hz) as rate:
        init_q = None
        it = 0
        for _ in range(max_iters):
            state = link.recv_state()
            if state is None:
                rate.sleep()
                continue
            if init_q is None:
                init_q = state["q"].copy()
            r = min(max(it / duration_iters, 0.0), 1.0)
            q_cmd = (1 - r) * init_q + r * targets
            link.send_cmd(q=q_cmd, kp=np.full(6, kp, np.float32),
                          kd=np.full(6, kd, np.float32))
            if error_test(targets, state["q"], tolerance):
                return True
            it += 1
            rate.sleep()
    return False


def zero_torque(link: rt.RobotLink) -> None:
    """Publish the all-zero safe-stop command: q = dq = tau = kp = kd = 0
    (PFControllerBase::zeroTorque, src/pf_controller_base.cpp:72-83)."""
    z = np.zeros(rt.NUM_JOINTS, np.float32)
    link.send_cmd(q=z, dq=z, tau=z, kp=z, kd=z)


def damping(link: rt.RobotLink, kd: float = 4.0) -> None:
    """Publish the damping safe-stop command: everything zero except
    kd (PFControllerBase::damping, src/pf_controller_base.cpp:86-97,
    which uses kd = 4)."""
    z = np.zeros(rt.NUM_JOINTS, np.float32)
    link.send_cmd(q=z, dq=z, tau=z, kp=z,
                  kd=np.full(rt.NUM_JOINTS, kd, np.float32))


class CalibrationError(RuntimeError):
    """A calibration diagnostic with nonzero code arrived: the analogue of
    the reference's abort() (src/mpc_control_fake_state.cpp:27-34)."""


# The input packet of a tick, [1, PACKET] float32: what the host copies in
# (joints, odometry, IMU, contacts, iteration: SENSORS floats), then the
# reference anchor (x, y, yaw) and the held force, which stay on the device
# between ticks. The solve tick reads the first SOLVE_IN floats.
Q, DQ, TAU = slice(0, 6), slice(6, 12), slice(12, 18)
POS, ORI, OQUAT, VPOS, VORI = (slice(18, 21), slice(21, 24), slice(24, 28),
                               slice(28, 31), slice(31, 34))
ODOM = slice(18, 34)
IQUAT, ACC, GYRO = slice(34, 38), slice(38, 41), slice(41, 44)
CONTACT, IT = slice(44, 46), slice(46, 47)
SENSORS = 47
ANCHOR = slice(47, 50)
SOLVE_IN = 50
GRF = slice(50, 56)
PACKET = 56
CMD = 30            # [q dq tau kp kd]
EST_PUB = 25        # [pos quat v_pos v_ori cov_diag(12)]
# the solve tick's output: the command, the next anchor, the force
W_ANCHOR, W_GRF = slice(30, 33), slice(33, 39)
# async dispatch: solves in flight at most (a slot of inputs and one of
# the force for each)
SLOTS = 4


def _odom(p) -> OdomState:
    return OdomState(pos=p[:, POS], ori=p[:, ORI], quat=p[:, OQUAT],
                     v_pos=p[:, VPOS], v_ori=p[:, VORI])


def _joints(p) -> JointState:
    return JointState(q=p[:, Q], dq=p[:, DQ], tau=p[:, TAU])


def _packed(cmd) -> torch.Tensor:
    return torch.cat([cmd.q, cmd.dq, cmd.tau, cmd.kp, cmd.kd], -1)


def _kernel_ticks(cfg, device) -> bool:
    """Whether a session on `device` runs its solve and held-force ticks as
    the ``walking_session_tick`` kernels: a CUDA device and a walking
    config that the tick kernels implement."""
    return (torch.device(device).type == "cuda" and cfg.mode == "walk"
            and tfc.kernel_refusal(cfg) is None)


class ControlSession:
    """The MPCWalking application: init -> start (move to zero) -> run.

    ``device``: where the controller runs (the card unless told
    otherwise). ``cuda_graphs`` (on the card; default True): replay each
    tick function as a CUDA graph captured when the session is made;
    False launches its kernels one by one.
    """

    def __init__(self, cfg: Optional[ControllerConfig] = None,
                 host_ip: str = "127.0.0.1", state_port: int = 17101,
                 cmd_port: int = 17102, device=None,
                 cuda_graphs: Optional[bool] = None):
        self.cfg = cfg or ControllerConfig.walking()
        self.device = default_device(device)
        c, dev, f32 = self.cfg, self.device, torch.float32
        self._cuda = self.device.type == "cuda"
        if cuda_graphs and not self._cuda:
            raise ValueError("cuda_graphs needs a CUDA device, got "
                             f"{self.device}")
        # walking reference anchor (cfg.ref_anchor_band): (x, y, yaw),
        # seeded by the first tick, advanced by every tick
        self._has_anchor = c.ref_anchor_band > 0.0 and c.mode == "walk"
        self._warm = c.qp_warm_start
        nu = 3 if c.mode == "walk" else 6
        n = nu * c.srbd.horizon
        self._packet = torch.zeros((1, PACKET), dtype=f32, device=dev)
        self._solve_in = torch.zeros((1, SOLVE_IN), dtype=f32, device=dev)
        self._z = torch.zeros((1, n), dtype=f32, device=dev)
        self._y = torch.zeros((1, 2 * n), dtype=f32, device=dev)
        self._warm_out = torch.zeros((1, W_GRF.stop), dtype=f32, device=dev)
        self._hold_out = torch.zeros((1, CMD), dtype=f32, device=dev)
        self._cold_out = torch.zeros((1, CMD), dtype=f32, device=dev)
        self._est_pub = torch.zeros((1, EST_PUB), dtype=f32, device=dev)
        self._kf_x = torch.zeros((1, 12), dtype=f32, device=dev)
        self._kf_p = torch.zeros((1, 12, 12), dtype=f32, device=dev)
        self.kf = KFState.initial((), c.estimator.initial_covariance, f32,
                                  dev)
        self.qp_state = self._initial_qp_state()
        self._held = False          # the packet holds a solved force
        self._slot_in = torch.zeros((SLOTS, 1, SOLVE_IN), dtype=f32,
                                    device=dev)
        self._slot_grf = torch.zeros((SLOTS, 1, 6), dtype=f32, device=dev)
        # the host side of the two copies a tick makes (pinned on the card)
        pin = self._cuda
        self._sens_h = torch.zeros((1, SENSORS), dtype=f32, pin_memory=pin)
        self._cmd_h = torch.zeros((1, CMD), dtype=f32, pin_memory=pin)
        self._pub_h = torch.zeros((1, EST_PUB), dtype=f32, pin_memory=pin)
        self._sens_np = self._sens_h.numpy()[0]
        self._sens_d = self._packet[:, :SENSORS]
        # the truth odometry until the first arrives: the nominal standing
        # pose (nothing but a truth tick writes the odometry here after)
        self._sens_np[POS.start + 2] = c.base_height
        self._sens_np[OQUAT.stop - 1] = 1.0
        # the solve and held-force ticks: one kernel launch each where the
        # tick kernels implement the walking config on the card
        self._kernel = _kernel_ticks(c, self.device)
        fns = {"est": self._est_fn}
        if self._kernel:
            fns.update({"warm": self._warm_kernel, "hold": self._hold_kernel})
        elif self._warm:
            fns.update({"warm": self._warm_fn, "hold": self._hold_fn})
        else:
            fns["cold"] = self._cold_fn
        self._fns = fns
        self._graphs = None
        self._timers = {}           # graph name -> (start, end) events
        if self._cuda:
            self._side = torch.cuda.Stream(dev)
            self._taken = [torch.cuda.Event() for _ in range(SLOTS)]
            if cuda_graphs is None or cuda_graphs:
                self._graphs = self._capture()
        self.tick_log = prof.TickLog()
        # the link last: nothing above can leave it open by raising
        self.link = rt.RobotLink(host_ip, state_port, cmd_port)
        # calibration-diagnostic abort gate: set False the moment a
        # calibration diagnostic with nonzero code arrives on the wire
        self.calibrated = True

    # -- state kept on the device, read and set like the JAX attributes
    @property
    def kf(self) -> KFState:
        """The filter state (x_hat [12], p_cov [12, 12]), a copy."""
        return KFState(x_hat=self._kf_x[0].clone(),
                       p_cov=self._kf_p[0].clone())

    @kf.setter
    def kf(self, value: KFState) -> None:
        self._kf_x.copy_(torch.as_tensor(value.x_hat).reshape(1, 12))
        self._kf_p.copy_(torch.as_tensor(value.p_cov).reshape(1, 12, 12))

    @property
    def qp_state(self):
        """The QP warm state (z, y), a copy; None without warm start."""
        if not self._warm:
            return None
        return (self._z[0].clone(), self._y[0].clone())

    @qp_state.setter
    def qp_state(self, value) -> None:
        if value is not None:
            self._z.copy_(torch.as_tensor(value[0]).reshape(self._z.shape))
            self._y.copy_(torch.as_tensor(value[1]).reshape(self._y.shape))

    @property
    def ref_anchor(self):
        """The walking reference anchor (x, y, yaw), a copy; None when the
        config tracks none."""
        return self._packet[0, ANCHOR].clone() if self._has_anchor else None

    def _initial_qp_state(self):
        """Cold warm-start state, as the JAX session makes it: z = 0
        controls; ADMM threads the scaled dual y (zeros), PDIP
        strictly-positive multipliers (ones). (The rollout's initial state
        starts the Riccati dual at ones: ROADMAP, "Not faults".)"""
        if not self.cfg.qp_warm_start:
            return None
        c = self.cfg.srbd
        fill = 0.0 if c.solver.method in ("admm", "admm_fused",
                                          "riccati") else 1.0
        return (torch.zeros_like(self._z[0]),
                torch.full_like(self._y[0], fill))

    # -- the tick functions: static tensors in, static tensors out
    def _est_fn(self):
        """KF tick on the packet's joints, IMU and contacts: writes the
        odometry into the packet, the filter state in place and the wire
        odometry [pos quat v_pos v_ori cov_diag] into _est_pub."""
        p = self._packet
        imu = ImuData(quat=p[:, IQUAT], acc=p[:, ACC], gyro=p[:, GYRO])
        out = est.estimator_tick(
            self.cfg, KFState(x_hat=self._kf_x, p_cov=self._kf_p),
            _joints(p), imu, p[:, CONTACT] > 0.5, self.cfg.gait.dt)
        o = out.odom
        p[:, ODOM].copy_(torch.cat([o.pos, o.ori, o.quat, o.v_pos, o.v_ori],
                                   -1))
        self._est_pub.copy_(torch.cat([
            o.pos, o.quat, o.v_pos, o.v_ori,
            torch.diagonal(out.kf.p_cov, dim1=-2, dim2=-1)], -1))
        self._kf_x.copy_(out.kf.x_hat)
        self._kf_p.copy_(out.kf.p_cov)

    def _warm_fn(self):
        """Warm solve tick on _solve_in: writes [command, next anchor,
        force] into _warm_out and the QP warm state in place."""
        p = self._solve_in
        cmd, diag = ctrl.tick(self.cfg, _odom(p), _joints(p), p[:, IT][:, 0],
                              qp_warm=(self._z, self._y),
                              ref_anchor=p[:, ANCHOR])
        self._warm_out.copy_(torch.cat([_packed(cmd), diag.ref_anchor,
                                        diag.grf], -1))
        self._z.copy_(diag.qp_state[0])
        self._y.copy_(diag.qp_state[1])

    def _hold_fn(self):
        """Held-force tick on the packet: the command into _hold_out, the
        next anchor into the packet."""
        p = self._packet
        cmd, diag = ctrl.tick(self.cfg, _odom(p), _joints(p), p[:, IT][:, 0],
                              grf_override=p[:, GRF],
                              ref_anchor=p[:, ANCHOR])
        self._hold_out.copy_(_packed(cmd))
        if self._has_anchor:
            p[:, ANCHOR].copy_(diag.ref_anchor)

    def _warm_kernel(self):
        """_warm_fn as one ``walking_session_tick`` launch."""
        tfc.walking_session_tick(self.cfg, self._solve_in, self._z, self._y,
                                 self._warm_out)

    def _hold_kernel(self):
        """_hold_fn as one ``walking_session_tick_hold`` launch."""
        tfc.walking_session_tick_hold(self.cfg, self._packet,
                                      self._hold_out)

    def _kernel_launches(self) -> int:
        return sum(k.launches for k in tfc.SESSION_KERNELS)

    def _cold_fn(self):
        """Tick without warm start (a cold solve every tick)."""
        p = self._packet
        cmd, _ = ctrl.tick(self.cfg, _odom(p), _joints(p), p[:, IT][:, 0])
        self._cold_out.copy_(_packed(cmd))

    def _capture(self) -> dict:
        """Capture each tick function as a CUDA graph (ops/graphs.py), after
        two eager runs on a nominal standing packet (they initialise the
        libraries' handles and load the kernels); the state they touch is
        put back."""
        from mpc_limx_control_tpu_torch.ops import graphs

        c = self.cfg
        nominal = torch.zeros((1, PACKET), dtype=torch.float32)
        nominal[0, POS.start + 2] = c.ground_height + c.base_height
        nominal[0, OQUAT.stop - 1] = nominal[0, IQUAT.stop - 1] = 1.0
        nominal[0, ACC.stop - 1] = 9.81
        nominal[0, CONTACT] = 1.0
        state = (self._packet, self._solve_in, self._z, self._y, self._kf_x,
                 self._kf_p)
        saved = [t.clone() for t in state]
        self._packet.copy_(nominal)
        self._solve_in.copy_(self._packet[:, :SOLVE_IN])
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                for fn in self._fns.values():
                    fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        # two timing events recorded inside each capture (event-record
        # nodes): a replay's device time from its first node to its last
        self._timers = {name: tuple(torch.cuda.Event(enable_timing=True,
                                                     external=True)
                                    for _ in range(2))
                        for name in self._fns}

        def timed(fn, start, end):
            def call():
                start.record()
                fn()
                end.record()
            return call

        out = {name: graphs.Graph(timed(fn, *self._timers[name]),
                                  name=f"ControlSession.{name}",
                                  device=self.device)
               for name, fn in self._fns.items()}
        for t, v in zip(state, saved):
            t.copy_(v)
        torch.cuda.synchronize(self.device)
        return out

    def _run(self, name: str) -> None:
        if self._graphs is not None:
            self._graphs[name].replay()
        else:
            self._fns[name]()

    def close(self):
        self.tick_log.close()
        self.link.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- safety commands (PFControllerBase, src/pf_controller_base.cpp:72-97)
    def zero_torque(self) -> None:
        zero_torque(self.link)

    def damping(self, kd: float = 4.0) -> None:
        damping(self.link, kd)

    def _poll_diagnostics(self) -> None:
        """Drain the diagnostic mailbox; trip the calibration gate on a
        nonzero calibration code (src/mpc_control_fake_state.cpp:27-34)."""
        d = self.link.recv_diag()
        if d is not None and d["name"] == rt.DIAG_CALIBRATION:
            self.calibrated = d["code"] == 0

    # -- init: calibration gate (src/mpc_control_fake_state.cpp:24-43)
    def init(self, settle_s: float = 0.05) -> None:
        """Wait briefly for any pending calibration diagnostic, then gate.

        On failure the robot is left in damping mode (the safe analogue of
        the reference's bare abort()) and CalibrationError raised."""
        deadline = rt.now_ns() + int(settle_s * 1e9)
        while rt.now_ns() < deadline:
            self._poll_diagnostics()
            if not self.calibrated:
                break
            time.sleep(0.001)
        if not self.calibrated:
            self.damping()
            raise CalibrationError("calibration diagnostic failed")

    # -- start: move to zero point (src/mpc_control_fake_state.cpp:48-102)
    def start(self, timeout_iters: int = 20000) -> bool:
        return move_group_joints(
            self.link, np.zeros(6, np.float32), kp=self.cfg.kp,
            kd=self.cfg.kd, tolerance=self.cfg.gait.given_error_rate,
            max_iters=timeout_iters)

    # -- the host side of a tick
    def _fill_sensors(self, it: int, state, imu_raw, odom_raw,
                      use_kf: bool) -> None:
        """Write the tick's host inputs into the pinned packet: joints,
        then the IMU and the gait clock's contact flags (KF), or the truth
        odometry where the tick brought one (the packet keeps the last;
        before any, the nominal standing pose), and the iteration. On the
        truth path the copy to the device is the one torch call."""
        s = self._sens_np
        s[Q], s[DQ], s[TAU] = state["q"], state["dq"], state["tau"]
        if use_kf:
            s[IQUAT], s[ACC], s[GYRO] = (imu_raw["quat"], imu_raw["acc"],
                                         imu_raw["gyro"])
            if self.cfg.mode == "stand":
                s[CONTACT] = 1.0
            else:
                # the gait clock on a CPU tensor: no device round trip
                ls = bool(gaitmod.gait_clock(
                    self.cfg.gait,
                    torch.tensor([float(it)], dtype=torch.float32))
                    .left_swing[0])
                s[CONTACT] = (float(not ls), float(ls))
        elif odom_raw is not None:
            # the fake-estimator path: ground-truth odometry over the wire
            # (include/state_estimator_fake.h:44-85), the orientation from
            # the quaternion as the packet holds it (float32)
            s[POS], s[OQUAT] = odom_raw["pos"], odom_raw["quat"]
            s[ORI] = rotu.quat_to_rpy_host(*s[OQUAT].tolist())
            s[VPOS], s[VORI] = odom_raw["v_pos"], odom_raw["v_ori"]
        s[IT] = float(it)
        self._sens_d.copy_(self._sens_h, non_blocking=True)

    def _fetch(self, packed: torch.Tensor, pub: bool) -> np.ndarray:
        """The one device-to-host copy of a tick (the command, and on a
        publishing KF tick the wire odometry), then wait for it."""
        self._cmd_h.copy_(packed, non_blocking=True)
        if pub:
            self._pub_h.copy_(self._est_pub, non_blocking=True)
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return self._cmd_h.numpy()[0]

    def _seed_anchor(self) -> None:
        """Seed the anchor at the first known base pose (x, y, yaw)."""
        p = self._packet
        p[:, ANCHOR].copy_(torch.cat([p[:, POS][:, :2], p[:, ORI][:, 2:3]],
                                     -1))

    def _dispatch(self, k: int):
        """Start the solve of the packet's tick on the side stream (async
        dispatch) through slot k; returns its completion event (None on
        the CPU, where it has finished)."""
        slot = self._slot_in[k]
        if not self._cuda:
            slot.copy_(self._packet[:, :SOLVE_IN])
            self._solve_in.copy_(slot)
            self._run("warm")
            self._slot_grf[k].copy_(self._warm_out[:, W_GRF])
            return None
        main = torch.cuda.current_stream(self.device)
        main.wait_event(self._taken[k])    # the slot's last solve read it
        slot.copy_(self._packet[:, :SOLVE_IN])
        filled = torch.cuda.Event()
        filled.record(main)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._side):
            self._side.wait_event(filled)
            self._solve_in.copy_(slot)
            self._taken[k].record(self._side)
            self._run("warm")
            self._slot_grf[k].copy_(self._warm_out[:, W_GRF])
            done.record(self._side)
        return done

    def _adopt(self, k: int, done) -> None:
        """Hold the force of the solve in slot k from this tick on."""
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        self._packet[:, GRF].copy_(self._slot_grf[k])

    # -- run: the 1 kHz MPC loop (src/mpc_control_fake_state.cpp:108-149)
    def run(self, iterations: int, hz: float = 1000.0,
            use_kf: bool = False, est_odom_every: int = 5,
            mpc_every: Optional[int] = None,
            async_dispatch: bool = False) -> dict:
        """Run `iterations` control ticks; returns loop statistics.

        As the JAX session's run: with cfg.qp_warm_start the GRF QP
        threads its warm state (z, y) tick to tick through the fused MPC
        kernel on the card, re-solving every `mpc_every` ticks (default
        cfg.gait.mpc_step = 5, the reference's dtMPC schedule,
        include/MPCParam.h:46-47) and holding the force in between.

        With `use_kf`, contact flags for the filter's noise gating come
        from the gait clock (include/stateEstimator.h:260-279), and the KF
        odometry + covariance diagonal is published back over the wire
        every `est_odom_every` ticks (include/stateEstimator.h:404-419).

        Every tick is logged in ``tick_log`` (``profiling.TickLog``: the
        phases poll, wire_in, fill, launch, wait, wire_out, sleep; the
        kind, hold / solve / cold; the device time of each graph the tick
        replayed). Stats, from the log's ticks of this call (its last
        ``TickLog.CAPACITY``): per-tick host latency (seconds, state
        receipt to the call of send_cmd) `tick_latency_p50/p95/max`,
        `solve_latency_p50` (solving ticks, warm or cold),
        `hold_latency_p50`, `ticks_over_1ms` (over the period),
        `solves_over_5ms`, `phase_p50_ms` (ms by span name, e.g.
        "session.wait"), and on CUDA graphs `hold_graph_device_p50_ms` /
        `solve_graph_device_p50_ms` (the hold / warm graph's device time a
        replay; the warm graph is not timed under async dispatch, whose
        solves the host does not wait for); counters `sent`, `stale`,
        `missed_deadlines`, `est_odom_published`, `mpc_solves`,
        `mpc_holds`, `kernel_ticks` (ticks that launched a session tick
        kernel, ``walking_session_tick*``: every tick of a walking session
        on the card whose config the tick kernels implement, 0 on the
        plain path).

        `async_dispatch`: every tick runs the held-force tick with the
        force of the newest completed solve, while the solves run on a
        stream of their own (their warm state chains there), started
        every `mpc_every` ticks; the host polls each solve's CUDA event.
        Adds `solves_dispatched`, `solves_adopted` and the measured force
        staleness `grf_staleness_p50/p95/max` (ticks).
        """
        if mpc_every is None:
            mpc_every = self.cfg.gait.mpc_step
        warm = self._warm
        stats = {"sent": 0, "stale": 0, "missed_deadlines": 0,
                 "est_odom_published": 0, "mpc_solves": 0, "mpc_holds": 0,
                 "solves_dispatched": 0, "solves_adopted": 0,
                 "kernel_ticks": 0}
        staleness: list = []
        pending: list = []      # async: (tick, slot, event), not adopted
        held_it = None          # tick the adopted force was solved at
        if async_dispatch and not warm:
            raise ValueError("async_dispatch requires the warm "
                             "(qp_warm_start) production path")
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._side)
        log = self.tick_log
        seen = self._kernel_launches()
        it = 0
        with rt.Rate(hz) as rate, log.running():
            while it < iterations:
                self._poll_diagnostics()
                if not self.calibrated:
                    self.damping()
                    raise CalibrationError(
                        "calibration diagnostic failed mid-run")
                state = self.link.recv_state()
                if state is None:
                    stats["stale"] += 1
                    rate.sleep()
                    continue
                log.mark(prof.WIRE_IN)
                imu_raw = self.link.recv_imu()
                if use_kf and imu_raw is None:
                    # the IMU datagram trails the state packet on the wire;
                    # wait briefly for it so the filter never skips a
                    # predict step
                    deadline = rt.now_ns() + 2_000_000        # 2 ms
                    while imu_raw is None and rt.now_ns() < deadline:
                        time.sleep(0.00005)
                        imu_raw = self.link.recv_imu()
                    if imu_raw is None:
                        stats["stale"] += 1
                        rate.sleep()
                        continue
                odom_raw = self.link.recv_odom()
                log.mark(prof.FILL)
                self._fill_sensors(it, state, imu_raw, odom_raw, use_kf)
                log.mark(prof.LAUNCH)
                pub = False
                if use_kf:
                    self._run("est")
                    pub = bool(est_odom_every) and it % est_odom_every == 0
                solve_now = (not warm) or (it % mpc_every == 0) \
                    or not self._held
                if self._has_anchor and it == 0:
                    self._seed_anchor()
                if async_dispatch:
                    # adopt the newest completed solve (a host-side poll)
                    ready = None
                    for i in range(len(pending) - 1, -1, -1):
                        ev = pending[i][2]
                        if ev is None or ev.query():
                            ready = i
                            break
                    if ready is not None:
                        held_it, k, ev = pending[ready]
                        self._adopt(k, ev)
                        del pending[:ready + 1]
                        stats["solves_adopted"] += 1
                    if it % mpc_every == 0 or not self._held:
                        if len(pending) == SLOTS - 1:
                            # every slot in flight: wait for the oldest
                            # solve, so that no slot is reused unread
                            held_it, k, ev = pending.pop(0)
                            ev.synchronize()
                            self._adopt(k, ev)
                            stats["solves_adopted"] += 1
                        k = stats["solves_dispatched"] % SLOTS
                        ev = self._dispatch(k)
                        pending.append((it, k, ev))
                        stats["solves_dispatched"] += 1
                        if not self._held:
                            # cold start: wait once for the first force
                            held_it = it
                            if ev is not None:
                                ev.synchronize()
                            self._adopt(k, ev)
                            self._held = True
                            pending.clear()
                            stats["solves_adopted"] += 1
                    solve_now = False
                    kind = prof.HOLD
                    self._run("hold")
                    packed = self._hold_out
                    if held_it is not None:
                        # (None: the force of an earlier run() call, held
                        # until this call's first solve is adopted)
                        staleness.append(it - held_it)
                elif warm and solve_now:
                    kind = prof.SOLVE
                    self._solve_in.copy_(self._packet[:, :SOLVE_IN])
                    self._run("warm")
                    # the next anchor and the force, into the packet
                    w = self._warm_out
                    if self._has_anchor:
                        self._packet[:, ANCHOR.start:GRF.stop].copy_(
                            w[:, W_ANCHOR.start:W_GRF.stop])
                    else:
                        self._packet[:, GRF].copy_(w[:, W_GRF])
                    self._held = True
                    packed = w[:, :CMD]
                elif warm:
                    kind = prof.HOLD
                    self._run("hold")
                    packed = self._hold_out
                else:
                    kind = prof.COLD
                    self._run("cold")
                    packed = self._cold_out
                log.mark(prof.WAIT)
                p = self._fetch(packed, pub)
                log.mark(prof.WIRE_OUT)
                if pub:
                    e = self._pub_h.numpy()[0]
                    self.link.send_est_odom(
                        pos=e[0:3], quat=e[3:7], v_pos=e[7:10],
                        v_ori=e[10:13], cov_diag=e[13:25],
                        stamp_ns=rt.now_ns())
                    stats["est_odom_published"] += 1
                log.mark(prof.SLEEP)
                self.link.send_cmd(
                    q=p[0:6], dq=p[6:12], tau=p[12:18], kp=p[18:24],
                    kd=p[24:30])
                if self._timers:
                    # the device times of the graphs the tick waited for,
                    # read once the command is out
                    self._time_graphs(kind, use_kf)
                if self._kernel:
                    # a tick whose calls launched a session tick kernel
                    before, seen = seen, self._kernel_launches()
                    stats["kernel_ticks"] += int(seen != before)
                stats["mpc_solves" if solve_now else "mpc_holds"] += 1
                stats["sent"] += 1
                it += 1
                stats["missed_deadlines"] += rate.sleep()
                log.end(kind, use_kf)
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._side)
        stats.update(_tick_stats(log.view(first_run=log.runs - 1), hz))
        if staleness:
            ss = sorted(staleness)
            stats["grf_staleness_p50"] = float(ss[len(ss) // 2])
            stats["grf_staleness_p95"] = float(
                ss[min(len(ss) - 1, int(0.95 * len(ss)))])
            stats["grf_staleness_max"] = float(ss[-1])
        return stats

    def _time_graphs(self, kind: int, use_kf: bool) -> None:
        """Log the device time of each graph the tick replayed on the
        main stream (after its synchronize: the events are done)."""
        start, end = self._timers[prof.KIND_GRAPHS[kind]]
        est = self._timers["est"]
        self.tick_log.device(start.elapsed_time(end),
                             est[0].elapsed_time(est[1]) if use_kf
                             else math.nan)


def _pct(xs, p: float) -> float:
    """The run statistics' percentile of sorted samples."""
    return float(xs[min(len(xs) - 1, int(p * len(xs)))])


def _tick_stats(ticks: prof.Ticks, hz: float) -> dict:
    """``run()``'s statistics of logged ticks (latency in seconds, phases
    and graph device times in ms)."""
    if not len(ticks):
        return {}
    lat = ticks.latency_ns() * 1e-9
    solving = ticks.kind != prof.HOLD
    out = {"tick_latency_p50": _pct(np.sort(lat), 0.50),
           "tick_latency_p95": _pct(np.sort(lat), 0.95),
           "tick_latency_max": float(lat.max()),
           "ticks_over_1ms": int((lat > 1.0 / hz).sum()),
           "phase_p50_ms": {span: _pct(np.sort(ticks.phase_ms(phase)), 0.50)
                            for phase, span in zip(prof.PHASES, prof.SPANS)}}
    if solving.any():
        out["solve_latency_p50"] = _pct(np.sort(lat[solving]), 0.50)
        out["solves_over_5ms"] = int((lat[solving] > 0.005).sum())
    if not solving.all():
        out["hold_latency_p50"] = _pct(np.sort(lat[~solving]), 0.50)
    for key, graph in (("hold_graph_device_p50_ms", "hold"),
                       ("solve_graph_device_p50_ms", "warm")):
        ms = ticks.device_ms(graph)
        if ms.size:
            out[key] = _pct(np.sort(ms), 0.50)
    return out
