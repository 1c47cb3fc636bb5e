# -*- coding: utf-8 -*-
# Generated by scripts/gen_fleet_pb2.py (protoc-free descriptor build).
# Source of truth: aios_tpu/protos/fleet.proto.  DO NOT EDIT!
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bfleet.proto\x12\naios.fleet"O\n\tPageEntry\x12\x12\n\x04hash\x18\x01 \x01(\x0cR\x04hash\x12\x14\n\x05crc32\x18\x02 \x01(\x07R\x05crc32\x12\x18\n\x07payload\x18\x03 \x01(\x0cR\x07payload"_\n\x0cFetchRequest\x12\x14\n\x05model\x18\x01 \x01(\tR\x05model\x12\x16\n\x06hashes\x18\x02 \x03(\x0cR\x06hashes\x12!\n\x0cbudget_bytes\x18\x03 \x01(\x04R\x0bbudgetBytes"R\n\tPageChunk\x12\x14\n\x05model\x18\x01 \x01(\tR\x05model\x12/\n\x07entries\x18\x02 \x03(\x0b2\x15.aios.fleet.PageEntryR\x07entries"A\n\x07PushAck\x12\x1a\n\x08accepted\x18\x01 \x01(\rR\x08accepted\x12\x1a\n\x08rejected\x18\x02 \x01(\rR\x08rejected"\x82\x03\n\x0eHandoffRequest\x12\x14\n\x05model\x18\x01 \x01(\tR\x05model\x12\x1d\n\nprompt_ids\x18\x02 \x03(\x05R\tpromptIds\x12\x1f\n\x0bemitted_ids\x18\x03 \x03(\x05R\nemittedIds\x12\x1d\n\nmax_tokens\x18\x04 \x01(\rR\tmaxTokens\x12 \n\x0btemperature\x18\x05 \x01(\x02R\x0btemperature\x12\x13\n\x05top_p\x18\x06 \x01(\x02R\x04topP\x12\x19\n\x08stop_ids\x18\x07 \x03(\x05R\x07stopIds\x12\x1d\n\nrequest_id\x18\x08 \x01(\tR\trequestId\x12\x1a\n\x08priority\x18\t \x01(\x05R\x08priority\x12\x1f\n\x0bsource_addr\x18\n \x01(\tR\nsourceAddr\x12\x1b\n\tkv_pushed\x18\x0b \x01(\x08R\x08kvPushed\x12\x18\n\x07attempt\x18\x0c \x01(\rR\x07attempt\x12\x16\n\x06tenant\x18\r \x01(\tR\x06tenant"\x81\x01\n\x0cHandoffChunk\x12\x14\n\x05token\x18\x01 \x01(\x05R\x05token\x12\x12\n\x04done\x18\x02 \x01(\x08R\x04done\x12!\n\x0cabort_reason\x18\x03 \x01(\tR\x0babortReason\x12$\n\x0eretry_after_ms\x18\x04 \x01(\rR\x0cretryAfterMs2\xc1\x01\n\nKvTransfer\x12:\n\x05Fetch\x12\x18.aios.fleet.FetchRequest\x1a\x15.aios.fleet.PageChunk0\x01\x124\n\x04Push\x12\x15.aios.fleet.PageChunk\x1a\x13.aios.fleet.PushAck(\x01\x12A\n\x07Handoff\x12\x1a.aios.fleet.HandoffRequest\x1a\x18.aios.fleet.HandoffChunk0\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'fleet_pb2', globals())
