"""The port's entry points (`repro.launch`'s counterpart): the AFL train
driver (`repro_torch.launch.train`, sharded over the ranks torchrun starts
with ``--mesh auto``), the serving driver (`repro_torch.launch.serve`), the
analytic FLOP and byte counts (`repro_torch.launch.analytic`) and the mesh
constructors (`repro_torch.launch.mesh`). The dry run over meta-device
stand-ins waits for ROADMAP A12."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
