"""The paper's primary contribution, MapReduce-decomposed deep learning, on
PyTorch: MapReduce jobs on ``torch.distributed``, RBM CD-k through kernel
K8, the DBN driver and the two fine-tuning heads.  The boosting of
``repro.core.adaboost`` is not ported yet (ROADMAP queue 1 item 16)."""
from .mapreduce import (REDUCE_MODES, DPGroups, dp_groups,  # noqa: F401
                        map_reduce_job, mapreduce_value_and_grad,
                        reduce_tree)
from .rbm import (RBMConfig, cd_statistics, free_energy,  # noqa: F401
                  make_rbm_step, rbm_init)
from .dbn import DBNConfig, forward_stack, train_dbn  # noqa: F401
from . import autoencoder, finetune  # noqa: F401
