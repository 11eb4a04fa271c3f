from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.pipeline import (FederatedData, build_federated,
                                       token_batches)
from repro_torch.data.synthetic import (ImageDataset, make_cifar10_like,
                                        make_femnist_like, make_token_stream)

__all__ = ["dirichlet_partition", "iid_partition", "FederatedData",
           "build_federated", "token_batches", "ImageDataset",
           "make_cifar10_like", "make_femnist_like", "make_token_stream"]
