from repro_torch.data.federated import (dirichlet_partition,  # noqa
                                        heterogeneity_score, iid_partition,
                                        labeled_mask, main_class_partition,
                                        realized_main_fraction)
from repro_torch.data.loader import (FederatedLoader, LMRoundLoader,  # noqa
                                     QuadraticLoader)
from repro_torch.data.synthetic import (ClassificationData,  # noqa
                                        QuadraticProblem, TokenStream)
