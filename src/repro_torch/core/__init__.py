"""The port's flat AFL server: the sampled-staleness engine, the ACE, ACED
and CA²FL rules over the flat gradient cache, and the vision task — the
counterpart of `repro.core`'s entry points."""
from repro_torch.core.aggregators import (ACED, CA2FL, ACEIncremental,
                                          make_aggregator)
from repro_torch.core.cache import FlatCache
from repro_torch.core.fl_tasks import make_vision_task
from repro_torch.core.scan_staleness import run_staleness_scan

__all__ = ["ACED", "ACEIncremental", "CA2FL", "FlatCache", "make_aggregator",
           "make_vision_task", "run_staleness_scan"]
