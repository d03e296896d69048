"""Host-side helpers: representations, MIDI writing, sampling precision."""
