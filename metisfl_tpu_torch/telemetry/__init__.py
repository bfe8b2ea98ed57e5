"""Telemetry: only the mergeable sketches the distributed slice tier
ships (``sketch.py``). The rest of the JAX package's ``telemetry/`` (the
metrics, events, spans and profiles) is not ported yet (ROADMAP.md
Queue 1 item 4)."""
