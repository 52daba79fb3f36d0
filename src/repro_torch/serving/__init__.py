from repro_torch.serving.engine import Completion, Request, ServeEngine
from repro_torch.serving.scheduler_service import (AdmissionError,
                                                   SchedulerService,
                                                   TransientRejection,
                                                   WorkflowHandle)
