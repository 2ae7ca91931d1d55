"""Process start to the opening of the measured window."""


def compute(rec):
    return rec["setup_s"]
