"""The benchmark's CPU tests; the ones marked cuda need a card."""
