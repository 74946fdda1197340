"""dia_prefill_ms: device ms of Dia's prompt processing a traced call.

The CUDA-event times of the program's "dia.encode" span (the text's
upload, the encoder and the cross caches) and "dia.prefill" span (the
decode state and the decoder's pass over the prompt block), which run back
to back on the model's stream, summed over a call (the spans under one
"dia.generate") and averaged over the traced calls: the "prompt
processing" half of a call, apart from its decode steps. Under the
profiler this eager, launch-bound phase runs slower than untraced.
"""

from benchmarks.program_spans import in_window


def read(trace, ctx):
    calls: dict = {}
    for s in in_window(trace) or ():
        if s.name in ("dia.encode", "dia.prefill") and s.device_ms is not None:
            calls.setdefault(s.request, {}).setdefault(s.name, 0.0)
            calls[s.request][s.name] += s.device_ms
    ms = [sum(call.values()) for call in calls.values() if len(call) == 2]
    return sum(ms) / len(ms) if ms else None
