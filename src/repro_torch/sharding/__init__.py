"""The client mesh's collectives (port of `repro.sharding`'s client-axis
parts): `collectives`."""
