"""Event-driven edge-fleet simulator (see sim.runner's docstring).

The port of ``repro.sim``, with the same public surface::

    from repro_torch.sim import Fleet, FleetSpec, SCENARIOS, simulate, SimResult
"""
from repro_torch.sim.clock import (Event, EventQueue, VirtualClock,  # noqa: F401
                                   trace_signature)
from repro_torch.sim.fleet import (Distribution, Fleet,  # noqa: F401
                                   FleetSpec, SCENARIOS, parse_scenario,
                                   effective_participation_q)
from repro_torch.sim.runner import SimResult, simulate  # noqa: F401

__all__ = ["Event", "EventQueue", "VirtualClock", "trace_signature",
           "Distribution", "Fleet", "FleetSpec", "SCENARIOS",
           "parse_scenario", "effective_participation_q",
           "SimResult", "simulate"]
