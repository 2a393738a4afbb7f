from repro_torch.models.model import (  # noqa: F401
    build_model, Model, init_params, params_from_reference,
)
