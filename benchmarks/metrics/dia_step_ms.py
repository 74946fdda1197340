"""dia_step_ms: wall ms of Dia's codes per decode-loop step.

The benchmark's "generate_codes" spans (encoder, prefill, decode loop and
the codes' copy to the host: the encoder and prefill are inside) over the
calls' decode steps, worked out from their returned lengths
(``tts_generate.steps``), so that how the program groups its steps does not
move the count.
"""


def read(trace, ctx):
    seconds = trace.span_s("generate_codes")
    if not seconds or not ctx.get("steps"):
        return None
    return 1e3 * seconds / ctx["steps"]
