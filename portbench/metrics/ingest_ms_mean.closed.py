"""Mean ms a call spent from the servicer's wire entry to its job's
hand-off to the dispatcher (the wire parse or prepack, admission, the
analytics' name tap, the lease copy), on the caller's thread, in the
window (``gubernator_phase_duration{phase="ingest"}``)."""
from portbench.lib.readers import hist_ms


def read(run):
    return hist_ms(run, "gubernator_phase_duration", phase="ingest")
