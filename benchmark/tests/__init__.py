"""CPU tests of the benchmark (and, marked ``cuda``, its controls on the card):

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
