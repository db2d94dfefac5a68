"""Host-side helpers: timing, rank-0 printing, FLOP accounting."""
