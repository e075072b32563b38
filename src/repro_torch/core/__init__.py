"""The paper's primary contribution, MapReduce-decomposed deep learning, on
PyTorch: MapReduce jobs on ``torch.distributed``, RBM CD-k through kernel
K8, the DBN's layer-wise loop (Algorithm 1), the two fine-tuning heads
and the AdaBoost (SAMME) precision refinement of §IV-C."""
from .mapreduce import (REDUCE_MODES, DPGroups, dp_groups,  # noqa: F401
                        map_reduce_job, mapreduce_value_and_grad,
                        reduce_tree)
from .rbm import (RBMConfig, cd_statistics, free_energy,  # noqa: F401
                  make_rbm_step, rbm_init)
from .dbn import DBNConfig, forward_stack, train_dbn  # noqa: F401
from . import adaboost, autoencoder, finetune  # noqa: F401
