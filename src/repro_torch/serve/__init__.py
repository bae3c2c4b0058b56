from .engine import PagedEngine
from .sampling import SamplingParams
from .scheduler import AdmissionPolicy, Request, RequestOutput

__all__ = ["AdmissionPolicy", "PagedEngine", "Request", "RequestOutput", "SamplingParams"]
