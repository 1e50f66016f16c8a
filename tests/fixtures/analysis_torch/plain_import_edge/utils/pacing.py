import time


def settle():
    time.sleep(0.01)  # seeded: hotpath-blocking
