"""The port's copy of the native runtime binding (ctypes + numpy).

``mpc_limx_control_tpu_torch/runtime.py`` is a verbatim copy of
``mpc_limx_control_tpu/runtime.py`` (the port imports nothing of the JAX
package): both build runtime/pf_runtime.cpp into the same
build/libpf_runtime.so. The copies are held byte-equal, and the port's is
driven over the UDP loopback on ports 19000-19099.
"""

import time
from pathlib import Path

import numpy as np
import pytest

from mpc_limx_control_tpu_torch import runtime as rt

from test_torch_session_walking import _pf_runtime_built  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib(_pf_runtime_built):
    return _pf_runtime_built


def test_runtime_copy_is_verbatim():
    """Edit both copies or neither (ROADMAP, North star rules)."""
    ours = (REPO / "mpc_limx_control_tpu_torch" / "runtime.py").read_bytes()
    theirs = (REPO / "mpc_limx_control_tpu" / "runtime.py").read_bytes()
    assert ours == theirs
    # and it resolves the repo root from its own place, as the JAX one
    assert rt._REPO == REPO
    assert rt._SRC.is_file()


def test_library_builds(lib):
    assert lib.exists() and lib == REPO / "build" / "libpf_runtime.so"


def test_loopback_roundtrip(lib):
    with rt.RobotHost(state_port=19001, cmd_port=19002) as host, \
            rt.RobotLink("127.0.0.1", state_port=19001,
                         cmd_port=19002) as link:
        q = np.arange(6, dtype=np.float32) * 0.1
        deadline = time.time() + 2.0
        got = None
        while got is None and time.time() < deadline:
            host.publish_state(q, dq=q * 2, stamp_ns=123)
            time.sleep(0.002)
            got = link.recv_state()
        assert got is not None, "no state received"
        np.testing.assert_allclose(got["q"], q, atol=1e-7)
        np.testing.assert_allclose(got["dq"], q * 2, atol=1e-7)
        imu = link.recv_imu()
        assert imu is not None
        np.testing.assert_allclose(imu["quat"], [0, 0, 0, 1], atol=1e-7)

        got_cmd = None
        deadline = time.time() + 2.0
        while got_cmd is None and time.time() < deadline:
            link.send_cmd(q=q + 1.0, kp=np.full(6, 60.0),
                          kd=np.full(6, 3.0), stamp_ns=77)
            time.sleep(0.002)
            got_cmd = host.poll_cmd()
        assert got_cmd is not None, "no cmd received"
        np.testing.assert_allclose(got_cmd["q"], q + 1.0, atol=1e-7)
        np.testing.assert_allclose(got_cmd["kp"], 60.0, atol=1e-7)


def test_est_odom_and_rate(lib):
    """The estimator odometry stream back to the host, and the rate
    loop's absolute deadlines (20 periods of 2 ms take ~40 ms)."""
    with rt.RobotHost(state_port=19003, cmd_port=19004) as host, \
            rt.RobotLink("127.0.0.1", state_port=19003,
                         cmd_port=19004) as link:
        deadline = time.time() + 2.0
        got = None
        while got is None and time.time() < deadline:
            link.send_est_odom(pos=(0.1, 0.2, 0.6), cov_diag=np.arange(12),
                               stamp_ns=9)
            time.sleep(0.002)
            got = host.poll_est_odom()
        assert got is not None
        np.testing.assert_allclose(got["pos"], [0.1, 0.2, 0.6], atol=1e-7)
        np.testing.assert_allclose(got["cov_diag"], np.arange(12), atol=0)
    with rt.Rate(500.0) as rate:
        t0 = time.perf_counter()
        for _ in range(20):
            rate.sleep()
        assert 0.03 < time.perf_counter() - t0 < 0.5
