"""dac_decoder_idle_share: the share of the traced window in which the
card was idle while the host was inside the program's "dac.decoder" span
(the decoder's launches), in %.

One of ``idle_launching_share``'s parts by DAC stage (prepare, encoder,
quantizer, decoder; the rest is "dac.forward" outside them).
"""

from benchmarks.program_spans import stage_idle_share


def read(trace, ctx):
    return stage_idle_share(trace, "dac.decoder")
