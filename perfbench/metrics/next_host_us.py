"""Host µs of one warm field-operator call, from the entry's call to its
return: the mean over a traced run's ``traced_calls`` calls, each issued to
idle cards (harness.host_spans), so that a full launch queue does not hold
the host inside the call."""


def read(run):
    spans = run.spans.get("next_call")
    return sum(spans) / len(spans) * 1e6 if spans else None
