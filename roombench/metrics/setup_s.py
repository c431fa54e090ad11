"""Set-up: process start to the first timed tick (builds, provider, room
load, traffic, warm tick)."""


def read(rec, name):
    return rec["setup_s"]
