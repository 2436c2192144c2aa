"""Data-parallel training across processes (counterpart of
go_with_the_flows_tpu/parallel): `dist` holds the process group, the
placement of batches on the ranks and the gathers of their results."""
