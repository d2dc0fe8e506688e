from repro_torch.models.diffusion import MASKABLE_BLOCKS, DiffusionLM
from repro_torch.models.model import Backbone, Model, build_model
