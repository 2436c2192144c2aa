"""TensorBoard reconstruction figures and the Open3D capture
(counterpart of go_with_the_flows_tpu/viz)."""

from .tb import add_figures_reconstruction_tb, add_svr_reconstruction_tb

__all__ = ["add_figures_reconstruction_tb", "add_svr_reconstruction_tb"]
