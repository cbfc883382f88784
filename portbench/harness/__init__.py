"""The benchmark of the PyTorch and CUDA port: the run of one cell
(`cell`), its inputs (`inputs`), the trace reader (`trace`), the counts
of operations and bytes (`flops`) and the comparison that decides
`correct` (`check`)."""
