"""The plant's step in float64 numpy, one scenario.

The same mathematics as the reference's plain modules (rotations, leg
kinematics, the exact zero-order hold of the SRBD in its vector form),
written for one scenario with numpy: a step takes some hundred
microseconds on the host, where the same composition in torch at batch 1
took milliseconds and held a 1 kHz loop to a fraction of its rate.
"""

from __future__ import annotations

import math

import numpy as np


def rpy_to_quat(rpy) -> np.ndarray:
    r, p, y = rpy[0] / 2, rpy[1] / 2, rpy[2] / 2
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    return np.array([sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy,
                     cr * cp * cy + sr * sp * sy])


def quat_to_rot(q) -> np.ndarray:
    x, y, z, w = q
    s = 2.0 / max(x * x + y * y + z * z + w * w, 1e-12)
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return np.array([[1 - (yy + zz), xy - wz, xz + wy],
                     [xy + wz, 1 - (xx + zz), yz - wx],
                     [xz - wy, yz + wx, 1 - (xx + yy)]])


def _rx(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _ry(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _wrap(a):
    return math.atan2(math.sin(a), math.cos(a))


class Leg:
    """One leg's chain constants (side sign applied)."""

    def __init__(self, offsets, side: str):
        m = np.array([1.0, 1.0 if side == "left" else -1.0, 1.0])
        self.abad = np.asarray(offsets.abad_offset) * m
        self.hip = np.asarray(offsets.hip_offset) * m
        self.knee = np.asarray(offsets.knee_offset) * m
        self.foot = (np.asarray(offsets.foot_offset)
                     + np.asarray(offsets.contact_offset)) * m

    def fk(self, q) -> np.ndarray:
        r0 = _rx(q[0])
        r01 = r0 @ _ry(q[1])
        r012 = r01 @ _ry(q[2])
        return self.abad + r0 @ self.hip + r01 @ self.knee + r012 @ self.foot

    def jacobian(self, q) -> np.ndarray:
        c0, s0 = math.cos(q[0]), math.sin(q[0])
        c1, s1 = math.cos(q[1]), math.sin(q[1])
        c12, s12 = math.cos(q[1] + q[2]), math.sin(q[1] + q[2])
        hy, hz = self.hip[1], self.hip[2]
        kx, ky, kz = self.knee
        fx, fy, fz = self.foot
        a1, b1 = c1 * kx + s1 * kz, -s1 * kx + c1 * kz
        a2, b2 = c12 * fx + s12 * fz, -s12 * fx + c12 * fz
        uy, uz = hy + ky + fy, hz + b1 + b2
        return np.array([[0.0, b1 + b2, b2],
                         [-s0 * uy - c0 * uz, s0 * (a1 + a2), s0 * a2],
                         [c0 * uy - s0 * uz, -c0 * (a1 + a2), -c0 * a2]])

    def ik(self, target, q_ref) -> np.ndarray:
        v = target - self.abad
        y_chain = self.hip[1] + self.knee[1] + self.foot[1]
        r = math.hypot(v[1], v[2])
        phi = math.atan2(v[2], v[1])
        d0 = math.acos(min(1.0, max(-1.0, y_chain / max(r, 1e-9))))
        a, b = _wrap(phi - d0), _wrap(phi + d0)
        q0 = a if abs(_wrap(a - q_ref[0])) <= abs(_wrap(b - q_ref[0])) else b
        u = _rx(q0).T @ v - self.hip
        ux, uz = u[0], u[2]
        ax, az = self.knee[0], self.knee[2]
        bx, bz = self.foot[0], self.foot[2]
        la2, lb2 = ax * ax + az * az, bx * bx + bz * bz
        rho = math.sqrt(la2 * lb2)
        psi = math.atan2(ax * bz - az * bx, ax * bx + az * bz)
        k = (ux * ux + uz * uz - la2 - lb2) / 2.0
        d2 = math.acos(min(1.0, max(-1.0, k / rho)))
        a, b = _wrap(psi - d2), _wrap(psi + d2)
        q2 = a if abs(_wrap(a - q_ref[2])) <= abs(_wrap(b - q_ref[2])) else b
        wx = ax + math.cos(q2) * bx + math.sin(q2) * bz
        wz = az - math.sin(q2) * bx + math.cos(q2) * bz
        q1 = _wrap(math.atan2(wz, wx) - math.atan2(uz, ux))
        return np.array([q0, q1, q2])


def _cross(a, b) -> np.ndarray:
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


class Srbd:
    """The exact zero-order hold of the SRBD with the shared-yaw inertia,
    in vector form (the same step as the 13 x 13 linearization and its
    discretization: theta' = theta + ts Rz' w + ts^2/2 Rz' wd,
    p' = p + ts v + ts^2/2 a, w' = w + ts wd, v' = v + ts a, with
    wd = Rz I^-1 Rz' sum_k (r_k x f_k) and a = sum_k f_k / m + g e_z)."""

    def __init__(self, robot):
        self.mass = float(robot.mass)
        self.i_inv = np.linalg.inv(
            np.asarray(robot.inertia, np.float64).reshape(3, 3))

    def step(self, xi, feet, forces, dt: float) -> np.ndarray:
        theta, p, w, v, g = xi[0:3], xi[3:6], xi[6:9], xi[9:12], xi[12]
        c, s = math.cos(theta[2]), math.sin(theta[2])
        rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        tau = sum(_cross(foot - p, f) for foot, f in zip(feet, forces))
        wd = rz @ (self.i_inv @ (rz.T @ tau))
        a = sum(forces) / self.mass + np.array([0.0, 0.0, g])
        half = dt * dt / 2.0
        return np.concatenate([theta + dt * (rz.T @ w) + half * (rz.T @ wd),
                               p + dt * v + half * a, w + dt * wd,
                               v + dt * a, [g]])


def make_step(cfg):
    """(xi, q, foot_l, foot_r, cmd_q, cmd_tau, cmd_kp) -> (xi, q, foot_l,
    foot_r, quat, acc, gyro, dq), float64 arrays of one scenario: the
    stance force reconstructed from the commanded stance torques
    (f_body = -(J^T)^-1 tau), the SRBD stepped, the swing leg executing
    its command and the stance foot pinned (walking) or both feet pinned
    (standing), the sensors a robot would measure."""
    gl = Leg(cfg.robot.legs, "left")
    gr = Leg(cfg.robot.legs, "right")
    srbd = Srbd(cfg.robot)
    dt = float(cfg.gait.dt)
    ground = float(cfg.ground_height)
    g_vec = np.array([0.0, 0.0, -9.81])
    stand = cfg.mode == "stand"

    def force(J, tau):
        return -np.linalg.solve(J.T, tau)

    def step(xi, q, foot_l, foot_r, cmd_q, cmd_tau, cmd_kp):
        R_wb = quat_to_rot(rpy_to_quat(xi[0:3]))
        if stand:
            f_l = R_wb @ force(gl.jacobian(q[:3]), cmd_tau[:3])
            f_r = R_wb @ force(gr.jacobian(q[3:]), cmd_tau[3:])
        else:
            left_swing = cmd_kp[0] > 0.0
            if left_swing:
                f_l = np.zeros(3)
                f_r = R_wb @ force(gr.jacobian(q[3:]), cmd_tau[3:])
            else:
                f_l = R_wb @ force(gl.jacobian(q[:3]), cmd_tau[:3])
                f_r = np.zeros(3)
        xi_new = srbd.step(xi, (foot_l, foot_r), (f_l, f_r), dt)
        base_new = xi_new[3:6]
        R_new = quat_to_rot(rpy_to_quat(xi_new[0:3]))
        if stand:
            q_new = np.concatenate([gl.ik(R_new.T @ (foot_l - base_new), q[:3]),
                                    gr.ik(R_new.T @ (foot_r - base_new),
                                          q[3:])])
        else:
            sw = gl if left_swing else gr
            q_sw = cmd_q[:3] if left_swing else cmd_q[3:]
            p = base_new + R_new @ sw.fk(q_sw)
            p[2] = max(p[2], ground)
            if left_swing:
                foot_l = p
                q_new = np.concatenate([q_sw, gr.ik(
                    R_new.T @ (foot_r - base_new), q[3:])])
            else:
                foot_r = p
                q_new = np.concatenate([gl.ik(
                    R_new.T @ (foot_l - base_new), q[:3]), q_sw])
        quat = rpy_to_quat(xi_new[0:3])
        a_w = (xi_new[9:12] - xi[9:12]) / dt
        return (xi_new, q_new, foot_l, foot_r, quat,
                R_new.T @ (a_w - g_vec), R_new.T @ xi_new[6:9],
                (q_new - q) / dt)

    return step
