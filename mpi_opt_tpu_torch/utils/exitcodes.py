"""The sweep processes' exit-code contract, in one place (port of
``mpi_opt_tpu/utils/exitcodes.py``; the values are the JAX package's,
so a supervisor classifies both packages' exits the same way).

The codes (sysexits.h where one exists):

- ``EX_OK`` (0): the sweep completed; the summary JSON line is final.
- ``EX_FAILURE`` (1): a retryable failure (an unclassified exception).
- ``EX_USAGE`` (2): argparse's usage-error code; no retry can help.
- ``EX_DATAERR`` (65): durable state is poisoned (no verified snapshot
  remains, or a journal diverges from the sweep it claims to record).
  A restart re-reads the same state, so a supervisor must not retry.
- ``EX_UNAVAILABLE`` (69): the fleet's zombie-fencing step-down.
- ``EX_IOERR`` (74): resource exhaustion as a classified answer
  (``utils/resources.py``): the disk filled after the one retention-
  prune retry, or the device ran out of memory. Durable state is
  intact, but a retry fails the same way until an operator frees the
  resource.
- ``EX_TEMPFAIL`` (75): the graceful-shutdown code: the sweep drained at
  a boundary with its durable state flushed. Restart it with
  ``--resume``; the retry budget is not billed.
- ``EX_PROTOCOL`` (76): a typed protocol refusal seen from a client.
"""

from __future__ import annotations

EX_OK = 0
EX_FAILURE = 1
EX_USAGE = 2
# sysexits.h EX_DATAERR: "input data was incorrect in some way"
EX_DATAERR = 65
# sysexits.h EX_UNAVAILABLE: "service unavailable"
EX_UNAVAILABLE = 69
# sysexits.h EX_IOERR: "an error occurred while doing I/O"
EX_IOERR = 74
# sysexits.h EX_TEMPFAIL: "temporary failure, user is invited to retry"
EX_TEMPFAIL = 75
# sysexits.h EX_PROTOCOL: "remote system returned something invalid"
EX_PROTOCOL = 76

_OUTCOMES = {
    EX_OK: "ok",
    EX_USAGE: "usage",
    EX_DATAERR: "data_error",
    EX_UNAVAILABLE: "unavailable",
    EX_IOERR: "io_error",
    EX_TEMPFAIL: "preempted",
    EX_PROTOCOL: "protocol",
}


def classify(rc: int) -> str:
    """Exit code -> outcome class: ``ok`` / ``usage`` / ``data_error`` /
    ``unavailable`` / ``io_error`` / ``preempted`` / ``protocol`` /
    ``failure`` (every other nonzero code, 1 included). ``preempted`` is
    the only outcome that means "resumable, for free"; ``usage`` and
    ``data_error`` are terminal; ``io_error`` is resumable after an
    operator frees the resource."""
    return _OUTCOMES.get(int(rc), "failure")
