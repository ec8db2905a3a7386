"""Service-provider interfaces: the formal boundary an external
connector implements (the ``core/trino-spi`` analog)."""
