from repro_torch.models.model import (Model, ModelCallConfig,  # noqa
                                      batch_struct, build, sample_batch,
                                      sample_ids)
