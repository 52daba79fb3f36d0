from repro_torch.serving.engine import Completion, Request, ServeEngine
