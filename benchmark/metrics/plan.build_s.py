"""Seconds ``ops.build_spmm_graph`` took, by the benchmark's clock around
it (the plans on the card included)."""


def read(rec):
    return rec['cell'].get('plan.build_s')
