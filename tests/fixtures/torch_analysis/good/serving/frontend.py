"""An event-loop driver that only awaits and reads host values. Parsed,
never run."""
import asyncio


async def drive(engine, tokens):
    await asyncio.sleep(0)
    return tokens.tolist()      # the engine's host array: no device sync
