"""The port's flat AFL server: the sampled-staleness engine (one run, seed
sweeps and lr × seed grids on one runner, the runner whose tick the card
replays as a CUDA graph, and the chunked runner; client fault schedules,
the guard pipeline and periodic resync), the nine rules of the zoo (ASGD,
delay-adaptive ASGD, FedBuff, CA²FL, ACE, ACED and the direct
CA²FL/ACE/ACED references) over the flat gradient cache, and the vision
task — the counterpart of `repro.core`'s entry points."""
from repro_torch.core.aggregators import (ACED, ALGORITHMS, CA2FL, ACEDDirect,
                                          ACEDirect, ACEIncremental,
                                          CA2FLDirect, DelayAdaptiveASGD,
                                          FedBuff, VanillaASGD,
                                          make_aggregator)
from repro_torch.core.cache import FlatCache
from repro_torch.core.fl_tasks import make_vision_task
from repro_torch.core.scan_staleness import (ChunkedStalenessRunner,
                                             FaultSchedule,
                                             build_fault_schedule,
                                             make_chunked_staleness_runner,
                                             make_staleness_runner, no_faults,
                                             run_staleness_grid,
                                             run_staleness_scan,
                                             run_staleness_seeds)

__all__ = ["ACED", "ACEDDirect", "ACEDirect", "ACEIncremental", "ALGORITHMS",
           "CA2FL", "CA2FLDirect", "ChunkedStalenessRunner",
           "DelayAdaptiveASGD", "FaultSchedule", "FedBuff", "FlatCache",
           "VanillaASGD", "build_fault_schedule", "make_aggregator",
           "make_chunked_staleness_runner", "make_staleness_runner",
           "make_vision_task", "no_faults", "run_staleness_grid",
           "run_staleness_scan", "run_staleness_seeds"]
