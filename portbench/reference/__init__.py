"""The benchmark's plain reference of the controller tick and its plant.

Frozen copies of the port's plain modules (configuration presets, state
containers, rotations, leg kinematics, gait clock, SRBD model,
condensation) and, in :mod:`portbench.reference.tick`, the plain
composition of one tick for the configurations the benchmark runs:
walking or standing, truth odometry, the warm fused ADMM with exact
triangular solves, the analytic IK. It imports torch and numpy only:
nothing of the port, of the JAX package or of JAX. The port's later
changes do not reach it; ``portbench/tests`` hold its presets equal to the
port's.
"""
