"""The mesh's collectives and sharding rules (port of `repro.sharding`):
`collectives`, `rules`, and the client axis's row blocks, `rows`."""
