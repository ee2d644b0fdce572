"""The JSDoop volunteer map-reduce runtime (port of ``repro.core``)."""
