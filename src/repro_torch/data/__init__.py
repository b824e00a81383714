from .availability import (AVAILABILITY_MODELS, ParticipationConfig,
                           participation_schedule, schedule_for_data)
from .partition import (dirichlet_proportions, pathological_assignment,
                        partition_pool_dirichlet, partition_pool_pathological)
from .synthetic import (FederatedData, make_federated_classification,
                        make_label_flip_data, make_lm_token_data)

__all__ = [
    "AVAILABILITY_MODELS", "ParticipationConfig", "participation_schedule",
    "schedule_for_data",
    "dirichlet_proportions", "pathological_assignment",
    "partition_pool_dirichlet", "partition_pool_pathological",
    "FederatedData", "make_federated_classification",
    "make_label_flip_data", "make_lm_token_data",
]
