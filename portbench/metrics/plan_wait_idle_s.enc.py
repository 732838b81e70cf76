"""plan_wait_idle_s.enc: seconds a compress call leaves the card idle
while the pipeline's main thread waits for the host planner's next
group (``ops/pipeline.py``, the span ``sqz.pipeline.wait_plan``): the
planner's time that the card does not hide.

Read in the exact-parse cell only, where the first wait is most of the
call's one long idle gap. ``trace.py`` gives that gap whole to the span
over its middle, so the reading also holds the container's host work
on the same gap (the split, join, checksum and pack of
``api.compress``, about 0.25 s a call of 10^8 B): it follows a change to
the planner second for second while the wait stays the gap's larger
part."""

from portbench.span_idle import idle_per_call

SPANS = ("sqz.pipeline.wait_plan",)


def read(t):
    return idle_per_call(t, SPANS)
