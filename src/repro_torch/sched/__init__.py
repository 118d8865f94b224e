"""Contact plans (the ported part of ``repro.sched``; the event-driven
scheduler comes with the next slice)."""
