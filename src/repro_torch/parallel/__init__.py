"""Logical-axis sharding rules: the LM mesh (DTensor placements on a
``DeviceMesh``) and the slot axis of the sharded KWS engine."""
