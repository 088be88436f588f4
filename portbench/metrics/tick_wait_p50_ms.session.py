"""The median of the session tick's `wait` phase, in ms: the enqueue of
the device-to-host copy of the command and the stream's synchronize, the
host blocked on the device.

Read from the port's tick log (utils/profiling.TickLog, the newest open
session's): the ticks of the run() calls after the first (set-up's) that
ran before any profiled tick. Once torch.profiler has run, the process
stays slower (a traced run's later ticks come at a fraction of the rate),
so a traced run reads the ticks before its traced chunk. None where the
port keeps no tick log."""

import numpy as np

from mpc_limx_control_tpu_torch.utils import profiling


def _ticks():
    logs = getattr(profiling, "tick_logs", list)()
    if not logs:
        return None
    ticks = logs[-1].view(first_run=1)
    ticks = ticks.take(np.cumsum(ticks.profiled) == 0)
    return ticks if len(ticks) else None


def read(record):
    ticks = _ticks()
    if ticks is None:
        return None
    return float(np.median(ticks.phase_ms("wait")))
