"""The yardstick's arithmetic: the card's peaks, the model's FLOPs and each
kernel's operations and bytes at the cell's shapes.

Copied from the program's own sound arithmetic (``utils/flops.py``'s
formulas, ``chip_smoke.py``'s ``bound`` and kernel counts) so that later
changes to the program cannot move the yardstick.
"""
