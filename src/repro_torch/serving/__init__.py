from repro_torch.serving.engine import Request, ServeEngine, frontend_inputs

__all__ = ["Request", "ServeEngine", "frontend_inputs"]
