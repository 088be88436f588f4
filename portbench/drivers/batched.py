"""Driver ``batched``: the batched closed loop through the port's public
``rollout.batched_rollout``.

The mix gives the batch B, the chunk of ticks a call, the MPC schedule
(``mpc_every``), the seeded perturbation of the start and the stagger of
the gait phases, the quality bands and the limits of the comparison. The
start is made here, from the seed, by the reference's own code on the
card (float32), and handed to both sides; a mix with ``episode_ticks``
starts the batch afresh from the next seeded start when an episode ends
(episodic scenarios, as a training pipeline resets them). Set-up runs the
first chunk (it builds and loads the kernels and warms every shape the
window uses); the window runs chunks until ``--seconds`` have passed, the
state carried from chunk to chunk, each chunk's metrics reduced on the
device before the next; it ends in ``torch.cuda.synchronize()``.

The check follows the program chunk by chunk from its own state, since a
closed loop of thousands of float32 ticks cannot be followed from the
start: the reference (float64, portbench/reference) runs the first chunk
from the benchmark's start and the window's last chunk from the state the
program carried into it, with the same iterations and schedule, and every
tick's force, QP residual, height, velocity and foot target and the
carried state after the chunk are compared. The window's quality (height
and forward velocity) is held to the mix's bands.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench import compare, work
from portbench.reference import config as rconfig
from portbench.reference import tick as rtick
from portbench.reference.precision import TF32Products
from portbench.trace import Profiler

PORT_STATE = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor")
PER_TICK = ("height", "velocity", "foot_target")


def build_config(module, spec: dict):
    """The configuration a spec names: ``preset`` (a classmethod of
    ControllerConfig) with ``overrides`` of its top-level fields (JSON
    lists become the tuples the frozen configuration holds)."""
    cfg = getattr(module.ControllerConfig, spec["preset"])()
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in spec.get("overrides", {}).items()}
    return dataclasses.replace(cfg, **over)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def perturbed_start(rcfg, mix: dict, gen: torch.Generator, device):
    """A seeded start: the reference's initial state (float32) with the
    mix's perturbations of xi, and the staggered start iterations [B],
    drawn from `gen` (each episode draws the next ones)."""
    B = int(mix["batch"])
    s = rtick.initial_state(rcfg, B, dtype=torch.float32, device=device)
    xi = s.xi.clone()
    for p in mix.get("perturb", []):
        if p["dist"] == "normal":
            d = p["scale"] * torch.randn(B, generator=gen, device=device)
        else:
            d = p["low"] + (p["high"] - p["low"]) * torch.rand(
                B, generator=gen, device=device)
        xi[:, int(p["index"])] += d
    stagger = int(mix.get("stagger", 0))
    it0 = (torch.randint(0, stagger, (B,), generator=gen, device=device)
           .to(torch.float32) if stagger > 0
           else torch.zeros(B, dtype=torch.float32, device=device))
    return dataclasses.replace(s, xi=xi), it0


class Cell:
    def __init__(self, spec: dict, mix: dict, seed: int, device,
                 trace: bool = False):
        self.spec, self.mix, self.seed = spec, mix, seed
        self.device = torch.device(device)
        self.prof = Profiler(trace)
        self.B = int(mix["batch"])
        self.chunk = int(mix["chunk"])
        self.mpc_every = int(mix.get("mpc_every", 1))
        self.program_step = None     # the timed entry; tests may wrap it

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from mpc_limx_control_tpu_torch.control import rollout as ro
        from mpc_limx_control_tpu_torch.core import config as pconfig

        self.ro = ro
        if self.program_step is None:
            self.program_step = ro.batched_rollout
        self.pcfg = build_config(pconfig, self.spec)
        self.rcfg = build_config(rconfig, self.spec)
        self.gen = generator(self.seed, self.device)
        self._reduce_init()
        self.first = self._run_chunk(None, 0)
        self.s = self.first[3]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_chunk(self, state, k: int):
        """Chunk k through the timed entry, its metrics reduced. Where the
        mix's ``episode_ticks`` end an episode (and for the first chunk)
        the batch starts afresh from the next seeded start, as episodic
        scenarios do. Returns (the state handed to the program, as the
        benchmark made it or the program carried it, the start iterations,
        the chunk's metrics, the state after it)."""
        ep = int(self.mix.get("episode_ticks", 0)) // self.chunk
        j = k % ep if ep else k
        if state is None or (ep and j == 0):
            s_in, self.it0 = perturbed_start(self.rcfg, self.mix, self.gen,
                                             self.device)
            state = self.ro.PlantState(**{
                f: (None if getattr(s_in, f) is None
                    else getattr(s_in, f).clone()) for f in PORT_STATE})
        else:
            s_in = state
        it = self.it0 + float(j * self.chunk)
        s_out, m = self.program_step(self.pcfg, state, self.chunk,
                                     start_iteration=it,
                                     mpc_every=self.mpc_every)
        self._reduce(m, s_out)
        return s_in, it, m, s_out

    def _episode_starts(self, k: int, n: int) -> bool:
        """Whether one of chunks k .. k + n - 1 starts an episode (the
        traced chunks hold none: a fresh start's kernels are traffic)."""
        ep = int(self.mix.get("episode_ticks", 0)) // self.chunk
        return bool(ep) and any((k + i) % ep == 0 for i in range(n))

    def _reduce_init(self) -> None:
        z = torch.zeros((), dtype=torch.float64, device=self.device)
        self.acc = {"height_sum": z.clone(), "vx_sum": z.clone(),
                    "height_min": torch.full_like(z, float("inf")),
                    "bad": torch.zeros(self.B, dtype=torch.bool,
                                       device=self.device)}

    def _reduce(self, m: dict, s) -> None:
        """Per-chunk reduction on the device: sums and minimum of the
        height, the forward velocity, and which scenarios went
        non-finite."""
        h = m["height"]
        a = self.acc
        a["height_sum"] += h.sum(dtype=torch.float64)
        a["vx_sum"] += m["velocity"][..., 0].sum(dtype=torch.float64)
        a["height_min"] = torch.minimum(a["height_min"],
                                        h.min().to(torch.float64))
        a["bad"] |= ~torch.isfinite(s.xi).all(-1)
        self.last_m = m

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        sync = (lambda: torch.cuda.synchronize(self.device)) \
            if self.device.type == "cuda" else (lambda: None)
        self._reduce_init()
        trace_chunks = int(self.mix.get("trace_chunks", 2))
        s, k, chunks, traced = self.s, 1, 0, not self.prof.on
        sync()
        t0 = time.perf_counter()
        while True:
            if (not traced and time.perf_counter() - t0 >= seconds / 3
                    and not self._episode_starts(k, trace_chunks)):
                # the traced chunks start on an idle device and end in a
                # synchronization: the window holds their kernels only
                sync()
                with self.prof.window(sync):
                    for _ in range(trace_chunks):
                        last = self._run_chunk(s, k)
                        s = last[3]
                        k += 1
                        chunks += 1
                traced = True
            else:
                last = self._run_chunk(s, k)
                s = last[3]
                k += 1
                chunks += 1
            if traced and time.perf_counter() - t0 >= seconds:
                break
        sync()
        wall = time.perf_counter() - t0
        self.last = last
        self.s = s
        ticks = chunks * self.chunk
        a = {k2: v.item() if v.ndim == 0 else v for k2, v in
             self.acc.items()}
        n = self.B * ticks
        last_h = self.last_m["height"].to(torch.float64)
        self.quality = {
            "height_min": a["height_min"],
            "height_mean": float(last_h.mean()),
            "vx_mean": float(self.last_m["velocity"][..., 0]
                             .to(torch.float64).mean())}
        failed = int(a["bad"].sum())
        self.window_ticks = ticks
        return {"metrics": {"scenario_ticks_per_s": n / wall},
                "attempted": self.B, "failed": failed,
                "notes": {"window": f"{ticks} ticks x {self.B} scenarios "
                                    f"in {wall:.6f} s ({chunks} chunks)",
                          "quality": self.quality,
                          "height_mean_window": a["height_sum"] / n,
                          "vx_mean_window": a["vx_sum"] / n}}

    def record(self) -> dict:
        r = dict(self.prof.record)
        c = self.pcfg
        nu = 3 if c.mode == "walk" else 6
        r["ticks"] = int(self.mix.get("trace_chunks", 2)) * self.chunk
        r["bound_ms_per_tick"] = work.mean_tick_bound_ms(
            nu, c.srbd.horizon, c.srbd.solver.admm_warm_iters, self.B,
            self.mpc_every)
        return r

    def release(self) -> None:
        """Free what the check does not read."""
        self.s = None
        self.acc = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def _ref_chunk(self, s_in, it, dtype, tf32=False):
        ref_in = rtick.State(**{k: (None if getattr(s_in, k) is None
                                    else getattr(s_in, k).to(dtype))
                                for k in PORT_STATE})
        if tf32:
            with TF32Products():
                return rtick.rollout(self.rcfg, ref_in, self.chunk, it,
                                     self.mpc_every)
        return rtick.rollout(self.rcfg, ref_in, self.chunk, it,
                             self.mpc_every)

    def chunk_gaps(self, s_in, it, m_prog, s_out, control=None) -> dict:
        """Per-field widest gaps of one chunk: the program's (or, with
        ``control``, the TF32 reference's) against the float64
        reference's."""
        with torch.no_grad():
            r_out, r_m = self._ref_chunk(s_in, it, torch.float64)
            if control == "tf32":
                c_out, c_m = self._ref_chunk(s_in, it, torch.float32,
                                             tf32=True)
                prog_state = {k: getattr(c_out, k) for k in PORT_STATE}
                prog_m = c_m
            else:
                prog_state = {k: getattr(s_out, k) for k in PORT_STATE}
                prog_m = m_prog
        ref_state = {k: getattr(r_out, k) for k in PORT_STATE}
        # forces (the GRF, the QP's z and its scaled dual y, in the units
        # of G z) on the largest force; the dimensionless residual and the
        # state in SI units on their largest magnitude or 1, whichever is
        # larger (a standing robot's velocity and residual sit near zero)
        force = float(r_m["grf"].abs().max())
        g = {"grf": compare.field_gap(prog_m["grf"], r_m["grf"], force),
             "qp_residual": compare.field_gap(
                 prog_m["qp_residual"], r_m["qp_residual"], floor=1.0)}
        g.update(compare.gaps(prog_m, r_m, PER_TICK, floor=1.0))
        g.update({f"final.{k}": v for k, v in compare.gaps(
            prog_state, ref_state, PORT_STATE, floor=1.0,
            scales={"qp_z": force, "qp_lam": force}).items()})
        return g

    def sample(self) -> torch.Tensor:
        """The scenarios the check compares: the mix's ``check_sample`` of
        them drawn from the seed (all when it names none or B)."""
        n = int(self.mix.get("check_sample", self.B))
        if n >= self.B:
            return torch.arange(self.B, device=self.device)
        gen = torch.Generator(device="cpu")
        gen.manual_seed((int(self.seed) + 1) % (2 ** 63))
        return torch.randperm(self.B, generator=gen)[:n].sort().values.to(
            self.device)

    def check(self, control=None) -> list:
        lim = self.mix["limits"]
        checks, notes = [], {}
        idx = self.sample()

        def pick(s):
            return self.ro._map_state(s, lambda x: x[idx]) \
                if isinstance(s, self.ro.PlantState) \
                else rtick.State(**{k: (None if getattr(s, k) is None
                                        else getattr(s, k)[idx])
                                    for k in PORT_STATE})

        for tag, (s_in, it, m, s_out) in (("start", self.first),
                                           ("last", self.last)):
            g = self.chunk_gaps(pick(s_in), it[idx],
                                {k: v[idx] for k, v in m.items()},
                                pick(s_out), control)
            notes[tag] = g
            state = max(v for k, v in g.items()
                        if k in PER_TICK or k.startswith("final."))
            checks += [
                compare.at_most(f"force_gap.{tag}", g["grf"],
                                lim["force_gap"]),
                compare.at_most(f"residual_gap.{tag}", g["qp_residual"],
                                lim["residual_gap"]),
                compare.at_most(f"state_gap.{tag}", state, lim["state_gap"])]
        checks += compare.quality_checks(self.quality, self.mix["quality"])
        self.gap_notes = notes
        import sys
        for tag, g in notes.items():
            print(f"note gaps.{tag}: " + " ".join(
                f"{k}={v:.6g}" for k, v in g.items()), file=sys.stderr)
        return checks

    def close(self) -> None:
        pass
