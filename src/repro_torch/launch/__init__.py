"""The port's entry points (`repro.launch`'s counterpart): the AFL train
driver (`repro_torch.launch.train`), the serving driver
(`repro_torch.launch.serve`) and the analytic FLOP and byte counts
(`repro_torch.launch.analytic`). The sharded mesh and the dry run wait for
the sharded runner (ROADMAP A10)."""
