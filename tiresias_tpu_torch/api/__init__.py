"""Library front door of the PyTorch port."""

from tiresias_tpu_torch.api.engine import (
    NOT_FOUND,
    STATUS_FOUND,
    STATUS_HANGUP,
    STATUS_NOTFOUND,
    SearchResult,
    Tiresias,
    parse_dialplan_args,
)

__all__ = [
    "NOT_FOUND",
    "STATUS_FOUND",
    "STATUS_HANGUP",
    "STATUS_NOTFOUND",
    "SearchResult",
    "Tiresias",
    "parse_dialplan_args",
]
