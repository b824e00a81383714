"""Entry points of the LM substrate (port of `repro.launch`): the prefill and
decode step makers and the serving loop."""
