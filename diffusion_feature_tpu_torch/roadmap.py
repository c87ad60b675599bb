"""What is not ported yet raises ``NotImplementedError`` naming the
ROADMAP.md Queue A item (a module) or Queue B item (a kernel) that brings
it."""

#: Queue A items the port's messages cite, by title.
QUEUE_A = {
    'DiT families': 9,
    'Training and tasks': 10,
    'Multi-GPU': 11,
    'external_model': 15,
}
#: Queue B items ("Still to port") the port's messages cite, by title.
QUEUE_B = {
    'Int8 weight-only dense': 3,
}
#: What an item still lacks, where part of it is ported.
REMAINING = {
    'DiT families': 'Flux and DeepFloyd-IF (PixArt and HunyuanDiT are ported)',
}


def not_ported(what: str, item: str, queue: str = 'A') -> NotImplementedError:
    number = (QUEUE_A if queue == 'A' else QUEUE_B)[item]
    rest = f'; still to come there: {REMAINING[item]}' if item in REMAINING else ''
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md, Queue {queue} "
                               f"item {number}: '{item}'{rest})")
