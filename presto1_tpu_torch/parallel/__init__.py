"""The mesh plane: hash exchange, distributed aggregation, joins and TopN
over a mesh of logical shards (``distributed.Mesh``)."""
