"""Python binding for the native pf_runtime C++ library (ctypes).

The controller-facing API mirrors the roles of the reference stack:

* :class:`RobotLink` — the PFControllerBase role (reference
  src/pf_controller_base.cpp): subscribe to robot state/IMU over UDP,
  publish joint commands.
* :class:`RobotHost` — the robot/Gazebo side: publish state, receive
  commands.  Used by the loopback simulator in tests and by any external
  plant process.
* :class:`Rate` — absolute-deadline 1 kHz loop timing
  (src/mpc_control_fake_state.cpp:57, with the milliseconds_per_step units
  bug fixed).

The shared library is compiled on demand with g++ into build/ and cached
by source mtime.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
from pathlib import Path

import numpy as np

NUM_JOINTS = 6

_REPO = Path(__file__).resolve().parent.parent
_SRC = _REPO / "runtime" / "pf_runtime.cpp"
_HDR = _REPO / "runtime" / "pf_runtime.h"
_BUILD = _REPO / "build"
_LIB = _BUILD / "libpf_runtime.so"


def build_library(force: bool = False) -> Path:
    """Compile runtime/pf_runtime.cpp to build/libpf_runtime.so (cached)."""
    _BUILD.mkdir(exist_ok=True)
    if (not force and _LIB.exists()
            and _LIB.stat().st_mtime > max(_SRC.stat().st_mtime,
                                           _HDR.stat().st_mtime)):
        return _LIB
    cmd = [
        "g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
        "-Wall", "-Werror", str(_SRC), "-o", str(_LIB),
        f"-I{_SRC.parent}",
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return _LIB


class _RobotState(C.Structure):
    _fields_ = [("stamp_ns", C.c_uint64),
                ("q", C.c_float * NUM_JOINTS),
                ("dq", C.c_float * NUM_JOINTS),
                ("tau", C.c_float * NUM_JOINTS)]


class _ImuData(C.Structure):
    _fields_ = [("stamp_ns", C.c_uint64),
                ("quat", C.c_float * 4),
                ("acc", C.c_float * 3),
                ("gyro", C.c_float * 3)]


class _RobotCmd(C.Structure):
    _fields_ = [("stamp_ns", C.c_uint64),
                ("mode", C.c_int32 * NUM_JOINTS),
                ("q", C.c_float * NUM_JOINTS),
                ("dq", C.c_float * NUM_JOINTS),
                ("tau", C.c_float * NUM_JOINTS),
                ("kp", C.c_float * NUM_JOINTS),
                ("kd", C.c_float * NUM_JOINTS)]


class _Odom(C.Structure):
    _fields_ = [("stamp_ns", C.c_uint64),
                ("pos", C.c_float * 3),
                ("quat", C.c_float * 4),
                ("v_pos", C.c_float * 3),
                ("v_ori", C.c_float * 3)]


class _Diag(C.Structure):
    _fields_ = [("stamp_ns", C.c_uint64),
                ("name", C.c_uint32),
                ("level", C.c_int32),
                ("code", C.c_int32)]


class _EstOdom(C.Structure):
    _fields_ = [("stamp_ns", C.c_uint64),
                ("pos", C.c_float * 3),
                ("quat", C.c_float * 4),
                ("v_pos", C.c_float * 3),
                ("v_ori", C.c_float * 3),
                ("cov_diag", C.c_float * 12)]


# diagnostic name ids (PFRT_DIAG_* in runtime/pf_runtime.h — wire-stable
# equivalents of the reference's DiagnosticValue.name strings,
# src/mpc_control_fake_state.cpp:27-34)
DIAG_CALIBRATION = 1
DIAG_ETHERCAT = 2
DIAG_IMU = 3


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    lib = C.CDLL(str(path))
    lib.pfrt_connect.restype = C.c_void_p
    lib.pfrt_connect.argtypes = [C.c_char_p, C.c_uint16, C.c_uint16]
    lib.pfrt_link_close.argtypes = [C.c_void_p]
    lib.pfrt_recv_state.argtypes = [C.c_void_p, C.POINTER(_RobotState)]
    lib.pfrt_recv_imu.argtypes = [C.c_void_p, C.POINTER(_ImuData)]
    lib.pfrt_recv_odom.argtypes = [C.c_void_p, C.POINTER(_Odom)]
    lib.pfrt_recv_diag.argtypes = [C.c_void_p, C.POINTER(_Diag)]
    lib.pfrt_send_cmd.argtypes = [C.c_void_p, C.POINTER(_RobotCmd)]
    lib.pfrt_send_est_odom.argtypes = [C.c_void_p, C.POINTER(_EstOdom)]
    lib.pfrt_link_state_count.restype = C.c_uint64
    lib.pfrt_link_state_count.argtypes = [C.c_void_p]

    lib.pfrt_serve.restype = C.c_void_p
    lib.pfrt_serve.argtypes = [C.c_uint16, C.c_uint16]
    lib.pfrt_host_close.argtypes = [C.c_void_p]
    lib.pfrt_publish_state.argtypes = [C.c_void_p, C.POINTER(_RobotState),
                                       C.POINTER(_ImuData)]
    lib.pfrt_publish_odom.argtypes = [C.c_void_p, C.POINTER(_Odom)]
    lib.pfrt_publish_diag.argtypes = [C.c_void_p, C.POINTER(_Diag)]
    lib.pfrt_poll_cmd.argtypes = [C.c_void_p, C.POINTER(_RobotCmd)]
    lib.pfrt_poll_est_odom.argtypes = [C.c_void_p, C.POINTER(_EstOdom)]
    lib.pfrt_host_cmd_count.restype = C.c_uint64
    lib.pfrt_host_cmd_count.argtypes = [C.c_void_p]

    lib.pfrt_rate_new.restype = C.c_void_p
    lib.pfrt_rate_new.argtypes = [C.c_double]
    lib.pfrt_rate_free.argtypes = [C.c_void_p]
    lib.pfrt_rate_sleep.argtypes = [C.c_void_p]
    lib.pfrt_now_ns.restype = C.c_uint64
    _lib = lib
    return lib


def _arr(ctype_arr) -> np.ndarray:
    return np.ctypeslib.as_array(ctype_arr).copy()


class RobotLink:
    """Controller-side UDP session (the PFControllerBase role)."""

    def __init__(self, host_ip: str = "127.0.0.1", state_port: int = 17101,
                 cmd_port: int = 17102):
        self._lib = _load()
        self._h = self._lib.pfrt_connect(host_ip.encode(), state_port,
                                         cmd_port)
        if not self._h:
            raise OSError("pfrt_connect failed")

    def close(self):
        if self._h:
            self._lib.pfrt_link_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def recv_state(self):
        """Latest robot state as dict of arrays, or None if stale."""
        s = _RobotState()
        if self._lib.pfrt_recv_state(self._h, C.byref(s)) != 1:
            return None
        return {"stamp_ns": s.stamp_ns, "q": _arr(s.q), "dq": _arr(s.dq),
                "tau": _arr(s.tau)}

    def recv_imu(self):
        d = _ImuData()
        if self._lib.pfrt_recv_imu(self._h, C.byref(d)) != 1:
            return None
        return {"stamp_ns": d.stamp_ns, "quat": _arr(d.quat),
                "acc": _arr(d.acc), "gyro": _arr(d.gyro)}

    def recv_odom(self):
        """Latest ground-truth odometry (the fake-estimator feed), or
        None if stale."""
        o = _Odom()
        if self._lib.pfrt_recv_odom(self._h, C.byref(o)) != 1:
            return None
        return {"stamp_ns": o.stamp_ns, "pos": _arr(o.pos),
                "quat": _arr(o.quat), "v_pos": _arr(o.v_pos),
                "v_ori": _arr(o.v_ori)}

    def recv_diag(self):
        """Latest robot diagnostic (name id, level, code), or None.

        The reference's subscribeDiagnosticValue channel
        (src/pf_controller_base.cpp:36-41): a calibration diagnostic with
        nonzero code must abort session init."""
        d = _Diag()
        if self._lib.pfrt_recv_diag(self._h, C.byref(d)) != 1:
            return None
        return {"stamp_ns": d.stamp_ns, "name": int(d.name),
                "level": int(d.level), "code": int(d.code)}

    def send_est_odom(self, pos, quat=(0, 0, 0, 1), v_pos=(0, 0, 0),
                      v_ori=(0, 0, 0), cov_diag=None, stamp_ns: int = 0):
        """Publish the estimator's odometry + covariance health (the
        stateEstimator 200 Hz odom/pose stream,
        include/stateEstimator.h:404-419)."""
        o = _EstOdom()
        o.stamp_ns = stamp_ns
        for i in range(3):
            o.pos[i] = float(pos[i])
            o.v_pos[i] = float(v_pos[i])
            o.v_ori[i] = float(v_ori[i])
        for i in range(4):
            o.quat[i] = float(quat[i])
        cov = (np.zeros(12, np.float32) if cov_diag is None
               else np.asarray(cov_diag, np.float32))
        for i in range(12):
            o.cov_diag[i] = float(cov[i])
        rc = self._lib.pfrt_send_est_odom(self._h, C.byref(o))
        if rc != 0:
            raise OSError(f"pfrt_send_est_odom: {rc}")

    def send_cmd(self, q, dq=None, tau=None, kp=None, kd=None, mode=None,
                 stamp_ns: int = 0):
        c = _RobotCmd()
        c.stamp_ns = stamp_ns

        def fill(dst, src, default=0.0):
            vals = (np.full(NUM_JOINTS, default, np.float32) if src is None
                    else np.asarray(src, np.float32))
            for i in range(NUM_JOINTS):
                dst[i] = vals[i]

        fill(c.q, q)
        fill(c.dq, dq)
        fill(c.tau, tau)
        fill(c.kp, kp)
        fill(c.kd, kd)
        m = (np.zeros(NUM_JOINTS, np.int32) if mode is None
             else np.asarray(mode, np.int32))
        for i in range(NUM_JOINTS):
            c.mode[i] = int(m[i])
        rc = self._lib.pfrt_send_cmd(self._h, C.byref(c))
        if rc != 0:
            raise OSError(f"pfrt_send_cmd: {rc}")

    @property
    def state_count(self) -> int:
        return self._lib.pfrt_link_state_count(self._h)


class RobotHost:
    """Robot / simulator side: publish state, poll commands."""

    def __init__(self, state_port: int = 17101, cmd_port: int = 17102):
        self._lib = _load()
        self._h = self._lib.pfrt_serve(state_port, cmd_port)
        if not self._h:
            raise OSError("pfrt_serve failed")

    def close(self):
        if self._h:
            self._lib.pfrt_host_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def publish_state(self, q, dq=None, tau=None, quat=(0, 0, 0, 1),
                      acc=(0, 0, 0), gyro=(0, 0, 0), stamp_ns: int = 0):
        s = _RobotState()
        s.stamp_ns = stamp_ns
        for i in range(NUM_JOINTS):
            s.q[i] = float(np.asarray(q)[i])
            s.dq[i] = 0.0 if dq is None else float(np.asarray(dq)[i])
            s.tau[i] = 0.0 if tau is None else float(np.asarray(tau)[i])
        d = _ImuData()
        d.stamp_ns = stamp_ns
        for i in range(4):
            d.quat[i] = float(quat[i])
        for i in range(3):
            d.acc[i] = float(acc[i])
            d.gyro[i] = float(gyro[i])
        rc = self._lib.pfrt_publish_state(self._h, C.byref(s), C.byref(d))
        if rc != 0:
            raise OSError(f"pfrt_publish_state: {rc}")

    def publish_odom(self, pos, quat=(0, 0, 0, 1), v_pos=(0, 0, 0),
                     v_ori=(0, 0, 0), stamp_ns: int = 0):
        o = _Odom()
        o.stamp_ns = stamp_ns
        for i in range(3):
            o.pos[i] = float(pos[i])
            o.v_pos[i] = float(v_pos[i])
            o.v_ori[i] = float(v_ori[i])
        for i in range(4):
            o.quat[i] = float(quat[i])
        rc = self._lib.pfrt_publish_odom(self._h, C.byref(o))
        if rc != 0:
            raise OSError(f"pfrt_publish_odom: {rc}")

    def publish_diag(self, name: int, code: int, level: int = 0,
                     stamp_ns: int = 0):
        """Publish a diagnostic value (calibration status etc.) to the
        controller."""
        d = _Diag()
        d.stamp_ns = stamp_ns
        d.name = int(name)
        d.level = int(level)
        d.code = int(code)
        rc = self._lib.pfrt_publish_diag(self._h, C.byref(d))
        if rc != 0:
            raise OSError(f"pfrt_publish_diag: {rc}")

    def poll_est_odom(self):
        """Latest estimator odometry published by the controller, or None."""
        o = _EstOdom()
        if self._lib.pfrt_poll_est_odom(self._h, C.byref(o)) != 1:
            return None
        return {"stamp_ns": o.stamp_ns, "pos": _arr(o.pos),
                "quat": _arr(o.quat), "v_pos": _arr(o.v_pos),
                "v_ori": _arr(o.v_ori), "cov_diag": _arr(o.cov_diag)}

    def poll_cmd(self):
        c = _RobotCmd()
        if self._lib.pfrt_poll_cmd(self._h, C.byref(c)) != 1:
            return None
        return {"stamp_ns": c.stamp_ns, "mode": _arr(c.mode),
                "q": _arr(c.q), "dq": _arr(c.dq), "tau": _arr(c.tau),
                "kp": _arr(c.kp), "kd": _arr(c.kd)}

    @property
    def cmd_count(self) -> int:
        return self._lib.pfrt_host_cmd_count(self._h)


class Rate:
    """Absolute-deadline rate loop (clock_nanosleep TIMER_ABSTIME)."""

    def __init__(self, hz: float):
        self._lib = _load()
        self._h = self._lib.pfrt_rate_new(float(hz))

    def sleep(self) -> int:
        """Sleep to next deadline; returns missed period count."""
        return self._lib.pfrt_rate_sleep(self._h)

    def close(self):
        if self._h:
            self._lib.pfrt_rate_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def now_ns() -> int:
    return _load().pfrt_now_ns()
