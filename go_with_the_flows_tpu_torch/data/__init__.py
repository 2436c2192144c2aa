"""Host-side data handling (counterpart of go_with_the_flows_tpu/data).
The port keeps its own copies: it imports nothing of the JAX package."""

from .cloud_sampling import sample_cloud
from .cloud_transforms import ComposeCloudTransformation
from .datasets import ShapeNetAllDataset, ShapeNetCoreDataset
from .image_transforms import ComposeImageTransformation
from .loader import DataLoader

__all__ = ["ComposeCloudTransformation", "ComposeImageTransformation",
           "DataLoader", "ShapeNetAllDataset", "ShapeNetCoreDataset",
           "sample_cloud"]
