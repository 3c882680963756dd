from repro_torch.data.loader import LMRoundLoader  # noqa
from repro_torch.data.synthetic import TokenStream  # noqa
