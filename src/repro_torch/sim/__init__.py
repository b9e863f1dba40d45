"""The request-level DaeMon simulator: workloads, traces, schemes and the
batched lattice replay (PyTorch counterpart of ``repro.sim``)."""
from repro_torch.sim.workloads import WORKLOADS, WorkloadParams
from repro_torch.sim.schemes import (SCHEMES, SchemeFlags, TraceableFlags,
                                     as_traceable, stack_flags)
from repro_torch.sim.trace import Trace, generate_trace, merge_traces
from repro_torch.sim.desim import (SimConfig, make_net, run_trace,
                                   simulate_grid, simulate_lattice)
