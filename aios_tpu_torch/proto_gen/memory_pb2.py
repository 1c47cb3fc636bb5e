# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: memory.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmemory.proto\x12\x0b\x61ios.memory\"\x07\n\x05\x45mpty\"m\n\x05\x45vent\x12\n\n\x02id\x18\x01 \x01(\t\x12\x11\n\ttimestamp\x18\x02 \x01(\x03\x12\x10\n\x08\x63\x61tegory\x18\x03 \x01(\t\x12\x0e\n\x06source\x18\x04 \x01(\t\x12\x11\n\tdata_json\x18\x05 \x01(\x0c\x12\x10\n\x08\x63ritical\x18\x06 \x01(\x08\"F\n\x13RecentEventsRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x10\n\x08\x63\x61tegory\x18\x02 \x01(\t\x12\x0e\n\x06source\x18\x03 \x01(\t\"/\n\tEventList\x12\"\n\x06\x65vents\x18\x01 \x03(\x0b\x32\x12.aios.memory.Event\"=\n\x0cMetricUpdate\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01\x12\x11\n\ttimestamp\x18\x03 \x01(\x03\"\x1c\n\rMetricRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\"<\n\x0bMetricValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01\x12\x11\n\ttimestamp\x18\x03 \x01(\x03\"\xe0\x01\n\x0eSystemSnapshot\x12\x13\n\x0b\x63pu_percent\x18\x01 \x01(\x01\x12\x16\n\x0ememory_used_mb\x18\x02 \x01(\x01\x12\x17\n\x0fmemory_total_mb\x18\x03 \x01(\x01\x12\x14\n\x0c\x64isk_used_gb\x18\x04 \x01(\x01\x12\x15\n\rdisk_total_gb\x18\x05 \x01(\x01\x12\x17\n\x0fgpu_utilization\x18\x06 \x01(\x01\x12\x14\n\x0c\x61\x63tive_tasks\x18\x07 \x01(\x05\x12\x15\n\ractive_agents\x18\x08 \x01(\x05\x12\x15\n\rloaded_models\x18\t \x03(\t\"\xa0\x01\n\nGoalRecord\x12\n\n\x02id\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\x12\x0e\n\x06status\x18\x03 \x01(\t\x12\x10\n\x08priority\x18\x04 \x01(\x05\x12\x12\n\ncreated_at\x18\x05 \x01(\x03\x12\x14\n\x0c\x63ompleted_at\x18\x06 \x01(\x03\x12\x0e\n\x06result\x18\x07 \x01(\t\x12\x15\n\rmetadata_json\x18\x08 \x01(\x0c\"8\n\nGoalUpdate\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\t\x12\x0e\n\x06result\x18\x03 \x01(\t\" \n\rGoalIdRequest\x12\x0f\n\x07goal_id\x18\x01 \x01(\t\"2\n\x08GoalList\x12&\n\x05goals\x18\x01 \x03(\x0b\x32\x17.aios.memory.GoalRecord\"\xd4\x01\n\nTaskRecord\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07goal_id\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\r\n\x05\x61gent\x18\x04 \x01(\t\x12\x0e\n\x06status\x18\x05 \x01(\t\x12\x12\n\ninput_json\x18\x06 \x01(\x0c\x12\x13\n\x0boutput_json\x18\x07 \x01(\x0c\x12\x12\n\nstarted_at\x18\x08 \x01(\x03\x12\x14\n\x0c\x63ompleted_at\x18\t \x01(\x03\x12\x13\n\x0b\x64uration_ms\x18\n \x01(\x03\x12\r\n\x05\x65rror\x18\x0b \x01(\t\"2\n\x08TaskList\x12&\n\x05tasks\x18\x01 \x03(\x0b\x32\x17.aios.memory.TaskRecord\"\xc1\x01\n\x0eToolCallRecord\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12\x11\n\ttool_name\x18\x03 \x01(\t\x12\r\n\x05\x61gent\x18\x04 \x01(\t\x12\x12\n\ninput_json\x18\x05 \x01(\x0c\x12\x13\n\x0boutput_json\x18\x06 \x01(\x0c\x12\x0f\n\x07success\x18\x07 \x01(\x08\x12\x13\n\x0b\x64uration_ms\x18\x08 \x01(\x03\x12\x0e\n\x06reason\x18\t \x01(\t\x12\x11\n\ttimestamp\x18\n \x01(\x03\"\xb4\x01\n\x08\x44\x65\x63ision\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07\x63ontext\x18\x02 \x01(\t\x12\x14\n\x0coptions_json\x18\x03 \x01(\x0c\x12\x0e\n\x06\x63hosen\x18\x04 \x01(\t\x12\x11\n\treasoning\x18\x05 \x01(\t\x12\x1a\n\x12intelligence_level\x18\x06 \x01(\t\x12\x12\n\nmodel_used\x18\x07 \x01(\t\x12\x0f\n\x07outcome\x18\x08 \x01(\t\x12\x11\n\ttimestamp\x18\t \x01(\x03\"\x83\x01\n\x07Pattern\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07trigger\x18\x02 \x01(\t\x12\x0e\n\x06\x61\x63tion\x18\x03 \x01(\t\x12\x14\n\x0csuccess_rate\x18\x04 \x01(\x01\x12\x0c\n\x04uses\x18\x05 \x01(\x05\x12\x11\n\tlast_used\x18\x06 \x01(\x03\x12\x14\n\x0c\x63reated_from\x18\x07 \x01(\t\"9\n\x0cPatternQuery\x12\x0f\n\x07trigger\x18\x01 \x01(\t\x12\x18\n\x10min_success_rate\x18\x02 \x01(\x01\"E\n\rPatternResult\x12%\n\x07pattern\x18\x01 \x01(\x0b\x32\x14.aios.memory.Pattern\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\"1\n\x12PatternStatsUpdate\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07success\x18\x02 \x01(\x08\"H\n\nAgentState\x12\x12\n\nagent_name\x18\x01 \x01(\t\x12\x12\n\nstate_json\x18\x02 \x01(\x0c\x12\x12\n\nupdated_at\x18\x03 \x01(\x03\"\'\n\x11\x41gentStateRequest\x12\x12\n\nagent_name\x18\x01 \x01(\t\"e\n\x15SemanticSearchRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12\x13\n\x0b\x63ollections\x18\x02 \x03(\t\x12\x11\n\tn_results\x18\x03 \x01(\x05\x12\x15\n\rmin_relevance\x18\x04 \x01(\x01\"i\n\x0cSearchResult\x12\x0f\n\x07\x63ontent\x18\x01 \x01(\t\x12\x15\n\rmetadata_json\x18\x02 \x01(\x0c\x12\x11\n\trelevance\x18\x03 \x01(\x01\x12\x12\n\ncollection\x18\x04 \x01(\t\x12\n\n\x02id\x18\x05 \x01(\t\";\n\rSearchResults\x12*\n\x07results\x18\x01 \x03(\x0b\x32\x19.aios.memory.SearchResult\"\xc7\x01\n\tProcedure\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\x12\n\nsteps_json\x18\x04 \x01(\x0c\x12\x15\n\rsuccess_count\x18\x05 \x01(\x05\x12\x12\n\nfail_count\x18\x06 \x01(\x05\x12\x17\n\x0f\x61vg_duration_ms\x18\x07 \x01(\x03\x12\x0c\n\x04tags\x18\x08 \x03(\t\x12\x12\n\ncreated_at\x18\t \x01(\x03\x12\x11\n\tlast_used\x18\n \x01(\x03\"\xa6\x01\n\x08Incident\x12\n\n\x02id\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\x12\x15\n\rsymptoms_json\x18\x03 \x01(\x0c\x12\x12\n\nroot_cause\x18\x04 \x01(\t\x12\x12\n\nresolution\x18\x05 \x01(\t\x12\x13\n\x0bresolved_by\x18\x06 \x01(\t\x12\x12\n\nprevention\x18\x07 \x01(\t\x12\x11\n\ttimestamp\x18\x08 \x01(\x03\"u\n\x0c\x43onfigChange\x12\n\n\x02id\x18\x01 \x01(\t\x12\x11\n\tfile_path\x18\x02 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x03 \x01(\t\x12\x12\n\nchanged_by\x18\x04 \x01(\t\x12\x0e\n\x06reason\x18\x05 \x01(\t\x12\x11\n\ttimestamp\x18\x06 \x01(\x03\"N\n\x0eKnowledgeEntry\x12\r\n\x05title\x18\x01 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x02 \x01(\t\x12\x0e\n\x06source\x18\x03 \x01(\t\x12\x0c\n\x04tags\x18\x04 \x03(\t\"T\n\x0e\x43ontextRequest\x12\x18\n\x10task_description\x18\x01 \x01(\t\x12\x12\n\nmax_tokens\x18\x02 \x01(\x05\x12\x14\n\x0cmemory_tiers\x18\x03 \x03(\t\"R\n\x0c\x43ontextChunk\x12\x0e\n\x06source\x18\x01 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x02 \x01(\t\x12\x11\n\trelevance\x18\x03 \x01(\x01\x12\x0e\n\x06tokens\x18\x04 \x01(\x05\"R\n\x0f\x43ontextResponse\x12)\n\x06\x63hunks\x18\x01 \x03(\x0b\x32\x19.aios.memory.ContextChunk\x12\x14\n\x0ctotal_tokens\x18\x02 \x01(\x05\x32\xd0\x0c\n\rMemoryService\x12\x33\n\tPushEvent\x12\x12.aios.memory.Event\x1a\x12.aios.memory.Empty\x12K\n\x0fGetRecentEvents\x12 .aios.memory.RecentEventsRequest\x1a\x16.aios.memory.EventList\x12=\n\x0cUpdateMetric\x12\x19.aios.memory.MetricUpdate\x1a\x12.aios.memory.Empty\x12\x41\n\tGetMetric\x12\x1a.aios.memory.MetricRequest\x1a\x18.aios.memory.MetricValue\x12\x44\n\x11GetSystemSnapshot\x12\x12.aios.memory.Empty\x1a\x1b.aios.memory.SystemSnapshot\x12\x38\n\tStoreGoal\x12\x17.aios.memory.GoalRecord\x1a\x12.aios.memory.Empty\x12\x39\n\nUpdateGoal\x12\x17.aios.memory.GoalUpdate\x1a\x12.aios.memory.Empty\x12;\n\x0eGetActiveGoals\x12\x12.aios.memory.Empty\x1a\x15.aios.memory.GoalList\x12\x38\n\tStoreTask\x12\x17.aios.memory.TaskRecord\x1a\x12.aios.memory.Empty\x12\x44\n\x0fGetTasksForGoal\x12\x1a.aios.memory.GoalIdRequest\x1a\x15.aios.memory.TaskList\x12@\n\rStoreToolCall\x12\x1b.aios.memory.ToolCallRecord\x1a\x12.aios.memory.Empty\x12:\n\rStoreDecision\x12\x15.aios.memory.Decision\x1a\x12.aios.memory.Empty\x12\x38\n\x0cStorePattern\x12\x14.aios.memory.Pattern\x1a\x12.aios.memory.Empty\x12\x44\n\x0b\x46indPattern\x12\x19.aios.memory.PatternQuery\x1a\x1a.aios.memory.PatternResult\x12I\n\x12UpdatePatternStats\x12\x1f.aios.memory.PatternStatsUpdate\x1a\x12.aios.memory.Empty\x12>\n\x0fStoreAgentState\x12\x17.aios.memory.AgentState\x1a\x12.aios.memory.Empty\x12H\n\rGetAgentState\x12\x1e.aios.memory.AgentStateRequest\x1a\x17.aios.memory.AgentState\x12P\n\x0eSemanticSearch\x12\".aios.memory.SemanticSearchRequest\x1a\x1a.aios.memory.SearchResults\x12<\n\x0eStoreProcedure\x12\x16.aios.memory.Procedure\x1a\x12.aios.memory.Empty\x12:\n\rStoreIncident\x12\x15.aios.memory.Incident\x1a\x12.aios.memory.Empty\x12\x42\n\x11StoreConfigChange\x12\x19.aios.memory.ConfigChange\x1a\x12.aios.memory.Empty\x12Q\n\x0fSearchKnowledge\x12\".aios.memory.SemanticSearchRequest\x1a\x1a.aios.memory.SearchResults\x12?\n\x0c\x41\x64\x64Knowledge\x12\x1b.aios.memory.KnowledgeEntry\x1a\x12.aios.memory.Empty\x12L\n\x0f\x41ssembleContext\x12\x1b.aios.memory.ContextRequest\x1a\x1c.aios.memory.ContextResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'memory_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=29
  _EMPTY._serialized_end=36
  _EVENT._serialized_start=38
  _EVENT._serialized_end=147
  _RECENTEVENTSREQUEST._serialized_start=149
  _RECENTEVENTSREQUEST._serialized_end=219
  _EVENTLIST._serialized_start=221
  _EVENTLIST._serialized_end=268
  _METRICUPDATE._serialized_start=270
  _METRICUPDATE._serialized_end=331
  _METRICREQUEST._serialized_start=333
  _METRICREQUEST._serialized_end=361
  _METRICVALUE._serialized_start=363
  _METRICVALUE._serialized_end=423
  _SYSTEMSNAPSHOT._serialized_start=426
  _SYSTEMSNAPSHOT._serialized_end=650
  _GOALRECORD._serialized_start=653
  _GOALRECORD._serialized_end=813
  _GOALUPDATE._serialized_start=815
  _GOALUPDATE._serialized_end=871
  _GOALIDREQUEST._serialized_start=873
  _GOALIDREQUEST._serialized_end=905
  _GOALLIST._serialized_start=907
  _GOALLIST._serialized_end=957
  _TASKRECORD._serialized_start=960
  _TASKRECORD._serialized_end=1172
  _TASKLIST._serialized_start=1174
  _TASKLIST._serialized_end=1224
  _TOOLCALLRECORD._serialized_start=1227
  _TOOLCALLRECORD._serialized_end=1420
  _DECISION._serialized_start=1423
  _DECISION._serialized_end=1603
  _PATTERN._serialized_start=1606
  _PATTERN._serialized_end=1737
  _PATTERNQUERY._serialized_start=1739
  _PATTERNQUERY._serialized_end=1796
  _PATTERNRESULT._serialized_start=1798
  _PATTERNRESULT._serialized_end=1867
  _PATTERNSTATSUPDATE._serialized_start=1869
  _PATTERNSTATSUPDATE._serialized_end=1918
  _AGENTSTATE._serialized_start=1920
  _AGENTSTATE._serialized_end=1992
  _AGENTSTATEREQUEST._serialized_start=1994
  _AGENTSTATEREQUEST._serialized_end=2033
  _SEMANTICSEARCHREQUEST._serialized_start=2035
  _SEMANTICSEARCHREQUEST._serialized_end=2136
  _SEARCHRESULT._serialized_start=2138
  _SEARCHRESULT._serialized_end=2243
  _SEARCHRESULTS._serialized_start=2245
  _SEARCHRESULTS._serialized_end=2304
  _PROCEDURE._serialized_start=2307
  _PROCEDURE._serialized_end=2506
  _INCIDENT._serialized_start=2509
  _INCIDENT._serialized_end=2675
  _CONFIGCHANGE._serialized_start=2677
  _CONFIGCHANGE._serialized_end=2794
  _KNOWLEDGEENTRY._serialized_start=2796
  _KNOWLEDGEENTRY._serialized_end=2874
  _CONTEXTREQUEST._serialized_start=2876
  _CONTEXTREQUEST._serialized_end=2960
  _CONTEXTCHUNK._serialized_start=2962
  _CONTEXTCHUNK._serialized_end=3044
  _CONTEXTRESPONSE._serialized_start=3046
  _CONTEXTRESPONSE._serialized_end=3128
  _MEMORYSERVICE._serialized_start=3131
  _MEMORYSERVICE._serialized_end=4747
# @@protoc_insertion_point(module_scope)
