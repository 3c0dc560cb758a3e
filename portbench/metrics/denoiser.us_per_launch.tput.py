"""Microseconds of the pipeline's sampling phase per denoiser kernel launch:
the seconds of the window's ``sampling`` spans that issued K1/K5 launches
over those launches (their ``launches`` attribute). None where no call of
the window ran K1/K5, or the program's ``sampling`` span carries no launch
count."""

from portbench.program_spans import window_spans


def read(run):
    spans = [s for s in window_spans(run, "sampling") or () if s.attrs.get("launches", 0) > 0]
    launches = sum(s.attrs["launches"] for s in spans)
    return 1e6 * sum(s.seconds for s in spans) / launches if launches else None
