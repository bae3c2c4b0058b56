from .engine import ContinuousEngine, Engine, GenerationResult, PagedEngine
from .kv_pool import BlockPool, KVPool
from .sampling import SamplingParams
from .scheduler import AdmissionPolicy, FinishedRequest, Request, RequestOutput, Scheduler

__all__ = [
    "AdmissionPolicy", "BlockPool", "ContinuousEngine", "Engine", "FinishedRequest",
    "GenerationResult", "KVPool", "PagedEngine", "Request", "RequestOutput", "SamplingParams",
    "Scheduler",
]
