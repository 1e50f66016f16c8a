import time


def flush():
    time.sleep(0.02)  # seeded: hotpath-blocking
