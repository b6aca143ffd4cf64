"""Leveled logging mirroring the reference's ast_log taxonomy.

The reference logs at ERROR/WARNING/NOTICE/VERBOSE/DEBUG throughout
(see e.g. fp_handler.c:76,123,130). Python's logging has
no NOTICE/VERBOSE; they are registered as custom levels between INFO and
DEBUG so log filtering behaves equivalently.
"""

from __future__ import annotations

import logging
import os

NOTICE = 25
VERBOSE = 15
logging.addLevelName(NOTICE, "NOTICE")
logging.addLevelName(VERBOSE, "VERBOSE")


class TiresiasLogger(logging.Logger):
    def notice(self, msg, *args, **kwargs):
        if self.isEnabledFor(NOTICE):
            self._log(NOTICE, msg, args, **kwargs)

    def verbose(self, msg, *args, **kwargs):
        if self.isEnabledFor(VERBOSE):
            self._log(VERBOSE, msg, args, **kwargs)


logging.setLoggerClass(TiresiasLogger)


def get_logger(name: str = "tiresias") -> TiresiasLogger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("TIRESIAS_LOG_LEVEL", "WARNING"))
    return logger  # type: ignore[return-value]
