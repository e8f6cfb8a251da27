"""Performance readout formatting (a copy of the JAX package's
engine/perf.py; reference: Util/SimulationPerfDisplay.cs,
Simulation.cs:440-461): MWrites/s, convergence xi, and ETA text."""

from __future__ import annotations


def format_perf_text(sim) -> str:
    """The reference's UIToolkit label content (SimulationPerfDisplay.cs:37-55)."""
    lines = [f"{sim.photons_per_second / 1e6:.1f} MPhotons/s",
             f"{sim.photon_writes_per_second / 1e6:.1f} MWrites/s"]
    from .simulation import Mode

    if sim.mode == Mode.REFERENCE:
        lines.append(f"Variance:   {sim.convergence_progress:.6f}")
        eta = sim.estimated_remaining_convergence_time
        if eta != float("inf"):
            lines.append(f"ETA:   {eta:.1f}s")
    return "\n".join(lines)
