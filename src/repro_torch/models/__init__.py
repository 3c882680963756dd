from repro_torch.models.model import Model, ModelCallConfig, build  # noqa
