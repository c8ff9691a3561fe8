"""Scale-out: sharding rules onto DTensor placements (``sharding``) and the
int8 error-feedback all-reduce (``compression``)."""
