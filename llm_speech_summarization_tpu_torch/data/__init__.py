"""Host audio frontend bindings (the native library under ``native/audio``)."""
