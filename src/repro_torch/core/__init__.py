"""The PICE system: scheduler, dispatcher, optimizer, ensemble, pipeline."""
