from repro_torch.federated.client import (accuracy, cnn_apply, cnn_init,
                                          local_train, xent_loss)
from repro_torch.federated.server import FLServer
from repro_torch.federated.simulation import (SimResult, compare_methods,
                                              make_data, make_topology,
                                              run_simulation,
                                              run_simulation_batch,
                                              run_simulation_sharded)

__all__ = ["accuracy", "cnn_apply", "cnn_init", "local_train", "xent_loss",
           "FLServer", "SimResult", "compare_methods",
           "make_data", "make_topology", "run_simulation",
           "run_simulation_batch", "run_simulation_sharded"]
