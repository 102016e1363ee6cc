from repro_torch.models.model_zoo import Model, build

__all__ = ["Model", "build"]
