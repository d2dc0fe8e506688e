from repro_torch.data.synthetic import (
    DataConfig,
    GaussianMixtureLatents,
    TokenStream,
    frontend_features,
    make_loader,
)
