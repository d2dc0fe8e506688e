from repro_torch.data.synthetic import frontend_features
