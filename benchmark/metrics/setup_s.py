"""Set-up: process start to the first timed step (data, plans or loader,
the three checked steps and the warm-up)."""


def read(rec):
    return rec['setup_s']
