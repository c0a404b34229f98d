from .datasets import FederatedDataset, load_dataset
from .pack import ClientPack, pack_partitions, split_train_val
from .partition import dirichlet_partition, uniform_partition
from .svmlight import canonicalize_labels, is_regression, load_svmlight
from .synthetic import generate_synthetic, synthetic_classification

__all__ = [
    "FederatedDataset",
    "load_dataset",
    "ClientPack",
    "pack_partitions",
    "split_train_val",
    "dirichlet_partition",
    "uniform_partition",
    "canonicalize_labels",
    "is_regression",
    "load_svmlight",
    "generate_synthetic",
    "synthetic_classification",
]
