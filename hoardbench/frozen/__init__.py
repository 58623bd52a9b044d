"""Copies of the program's yardsticks, frozen so that a change to the program
cannot move them: the corpus generation (``corpus``), the kernels' cost
formulas (``cost``) and the profiler's kernel grouping (``groups``).
``tests/test_hb_frozen.py`` holds each against its original as it stands."""
