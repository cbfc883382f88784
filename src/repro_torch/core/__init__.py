"""The port's AFL server: the host references (`AFLSimulator`,
`StalenessSimulator`: each protocol driven from the host one event at a
time, the loop the engines are held against), the sampled-staleness
engine (one run, seed sweeps and lr × seed grids on one runner, the
runner whose tick the card replays as a CUDA graph, and the chunked
runner, in the flat layout or the tree layout (``layout="tree"``: tree
caches over the parameter structure, an int8 history ring); client fault
schedules, the guard pipeline and periodic resync), the event-driven
engine (`run_scan`, `run_scan_seeds`, `sweep` over `build_schedule`'s
delay schedules), the sanitize checks of both (``checkify_invariants``),
the nine rules of the zoo (ASGD, delay-adaptive ASGD, FedBuff, CA²FL, ACE,
ACED and the direct CA²FL/ACE/ACED references) over the flat or tree
gradient cache, and the vision, text and LM tasks — the counterpart of
`repro.core`'s entry points."""
from repro_torch.core.aggregators import (ACED, ALGORITHMS, CA2FL, ACEDDirect,
                                          ACEDirect, ACEIncremental,
                                          CA2FLDirect, DelayAdaptiveASGD,
                                          FedBuff, VanillaASGD,
                                          make_aggregator)
from repro_torch.core.cache import FlatCache
from repro_torch.core.delays import (ExponentialDelays, Schedule,
                                     arrival_schedule, build_schedule)
from repro_torch.core.fl_tasks import (make_lm_task, make_text_task,
                                      make_vision_task)
from repro_torch.core.scan_engine import (ScanResult, make_scan_runner,
                                          run_scan, run_scan_seeds, sweep)
from repro_torch.core.simulator import AFLSimulator, SimResult
from repro_torch.core.staleness_sim import StalenessSimulator
from repro_torch.core.scan_staleness import (ChunkedStalenessRunner,
                                             FaultSchedule,
                                             build_fault_schedule,
                                             make_chunked_staleness_runner,
                                             make_staleness_runner, no_faults,
                                             run_staleness_grid,
                                             run_staleness_scan,
                                             run_staleness_seeds)

__all__ = ["ACED", "ACEDDirect", "ACEDirect", "ACEIncremental", "AFLSimulator",
           "ALGORITHMS", "CA2FL", "CA2FLDirect", "ChunkedStalenessRunner",
           "DelayAdaptiveASGD", "ExponentialDelays", "FaultSchedule",
           "FedBuff", "FlatCache", "ScanResult", "Schedule", "SimResult",
           "StalenessSimulator", "VanillaASGD",
           "arrival_schedule", "build_fault_schedule", "build_schedule",
           "make_aggregator", "make_chunked_staleness_runner", "make_lm_task",
           "make_scan_runner", "make_staleness_runner", "make_text_task",
           "make_vision_task", "no_faults", "run_scan", "run_scan_seeds",
           "run_staleness_grid", "run_staleness_scan", "run_staleness_seeds",
           "sweep"]
