from .datasets import FederatedDataset, load_dataset
from .loaders import MinibatchLoader, load_data
from .pack import ClientPack, bucket_partitions, pack_partitions, split_train_val
from .partition import dirichlet_partition, uniform_partition
from .stream import CohortShardStream
from .svmlight import canonicalize_labels, is_regression, load_svmlight
from .synthetic import generate_synthetic, synthetic_classification

__all__ = [
    "CohortShardStream",
    "FederatedDataset",
    "load_dataset",
    "MinibatchLoader",
    "load_data",
    "ClientPack",
    "bucket_partitions",
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
