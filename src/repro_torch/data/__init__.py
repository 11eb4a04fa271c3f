from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import FederatedData, build_federated
from repro_torch.data.synthetic import (ImageDataset, make_cifar10_like,
                                        make_femnist_like)

__all__ = ["dirichlet_partition", "FederatedData", "build_federated",
           "ImageDataset", "make_cifar10_like", "make_femnist_like"]
